// Gamma-ladder weight sums: for K candidate tempering increments dg_k,
//   s1[k] = sum_i exp(d_i * dg_k),   s2[k] = sum_i exp(d_i * dg_k)^2.
//
// Replaces: smc_tpu/ops/ladder_pallas.py, _ladder_kernel (the Pallas TPU
// kernel behind ladder_stats). On the TPU the grid runs in order and the
// kernel carries (K, tile) accumulators in VMEM from one grid step to the
// next. Hopper blocks run in parallel and carry nothing across, so this is
// two passes: each block writes its own partial sums, and a second small
// kernel adds the partials of all blocks in a fixed order. There are no
// fp32 atomics, so the sums, and the ESS threshold decision find_gamma takes
// from them, are the same from run to run.
//
// What bounds it on the H100: operations. N*K expf plus four fp32 operations
// each, against 4*N bytes of input; at K = 81 that is ~100 operations per
// byte, above the card's ~20 fp32 operations per byte of HBM. At the main
// path's N = 1e5 the whole pass is a few microseconds of work, so latency
// (enough warps in flight, short dependency chains) decides the time.
//
// What the design does about it: the grid is (particle tiles) x (candidate
// groups), one candidate per warp, so N = 1e5 already puts ~4k warps in
// flight; each lane keeps four independent pairs of sums (a dependency
// chain a quarter as long), and a warp shuffle tree reduces them. d is read
// from HBM once; the other candidate groups of a tile hit it in L2/L1.
// -inf entries of d contribute exp(-inf * dg) = 0 because dg > 0; the
// ragged tail is masked, not padded.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // 8 warps: 8 candidates a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                // particles per block x-step
constexpr int kMaxBlocks = 264;            // grid x cap (two per H100 SM);
                                           // a larger N loops over tiles

__global__ void __launch_bounds__(kThreads)
ladder_partial_kernel(const float* __restrict__ d, const float* __restrict__ dg,
                      float* __restrict__ partial, int n, int k_count) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (k >= k_count) return;  // whole warps leave; no block barrier below
  const float g = dg[k];
  float a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float a2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < n;
       base += static_cast<long long>(gridDim.x) * kTile) {
    const long long end = base + kTile < n ? base + kTile : n;
    for (long long i = base + lane; i < end; i += 4 * 32) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long j = i + u * 32;
        if (j < end) {
          const float w = expf(__ldg(d + j) * g);
          a1[u] += w;
          a2[u] += w * w;
        }
      }
    }
  }
  float s1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
  float s2 = (a2[0] + a2[1]) + (a2[2] + a2[3]);
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * k_count;
    out[k] = s1;
    out[k_count + k] = s2;
  }
}

// One thread per output sum; the blocks' partials are added in block order.
__global__ void ladder_final_kernel(const float* __restrict__ partial,
                                    float* __restrict__ s1,
                                    float* __restrict__ s2, int n_blocks,
                                    int k_count) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * k_count) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b)
    s += partial[static_cast<size_t>(b) * 2 * k_count + j];
  if (j < k_count)
    s1[j] = s;
  else
    s2[j - k_count] = s;
}

}  // namespace

// The grid's particle-tile extent for n particles: the caller sizes the
// partial-sum scratch of ladder_launch from it.
extern "C" int ladder_blocks(int n) {
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  return tiles < 1 ? 1 : (tiles < kMaxBlocks ? static_cast<int>(tiles)
                                             : kMaxBlocks);
}

// d_ll (n,), dg (k,) -> s1, s2 (k,); partial is (ladder_blocks(n), 2, k)
// scratch. All float32, contiguous, on the device of `stream`.
extern "C" int ladder_launch(const float* d_ll, const float* dg, float* partial,
                             float* s1, float* s2, int n, int k,
                             void* stream) {
  if (k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = ladder_blocks(n);
  const dim3 grid(n_blocks, (k + kWarps - 1) / kWarps);
  ladder_partial_kernel<<<grid, kThreads, 0, s>>>(d_ll, dg, partial, n, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 128;
  ladder_final_kernel<<<(2 * k + threads - 1) / threads, threads, 0, s>>>(
      partial, s1, s2, n_blocks, k);
  return static_cast<int>(cudaGetLastError());
}
