// Fixed-step RK4 Michaelis-Menten log-likelihood, one thread per particle.
//
// Replaces: smc_tpu/ops/mm_pallas.py, _mm_kernel (the Pallas TPU kernel
// behind mm_loglik_pallas, the model's method="pallas").
//
// What it computes, per particle p with theta = (Vmax, Km, sigma): for each
// of n_ds datasets, S marches from s0 over the n_obs - 1 intervals of the
// uniform observation grid with `substeps` classical RK4 steps of
// h = dt / substeps on f(S) = -Vmax S / (Km + S); the residual at every grid
// point is r = obs - (s0 - S); ll = -0.5 n_obs n_ds (ln 2pi + 2 ln sigma~)
// - sum r^2 / (2 sigma~^2) with sigma~ = max(sigma, 1e-12). sigma <= 0 or a
// NaN result gives -inf. The arithmetic follows the TPU kernel op for op:
// Km is NOT clamped (Km + S = 0 gives a NaN that comes out as -inf); the
// stage sum is ((k1 + 2 k2) + 2 k3) + k4; r^2 is summed over time per
// dataset and the datasets are added last, in order; h, h/2 and h/6 are
// rounded from double on the host, as the Python floats of the TPU kernel
// are when they meet fp32 arrays.
//
// What bounds it on the H100: operations. A particle does
// n_ds (n_obs - 1) substeps RK4 steps, each with four IEEE divisions, and
// moves 16 bytes (theta in, ll out).
//
// What the design does about it: the state, the stages and the running sums
// stay in registers for the whole march; obs and s0 sit in shared memory,
// read by all threads of a block at the same address (a broadcast). The TPU
// kernel's (1, block) lane blocks, its static unroll over the grid and its
// padding of the particle axis with ones were layout artefacts of that
// machine and are dropped: the time loop is a loop, and the ragged tail is
// masked.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

constexpr float kLog2Pi = static_cast<float>(1.8378770664093453);

// max that keeps a NaN, as jnp.maximum does (fmaxf drops it).
__device__ __forceinline__ float nan_max(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float mm_rate(float vmax, float km, float s) {
  return (-vmax * s) / (km + s);
}

__global__ void __launch_bounds__(kThreads)
mm_rk4_kernel(const float* __restrict__ theta, const float* __restrict__ obs,
              const float* __restrict__ s0, float* __restrict__ ll, int n,
              int n_ds, int n_obs, int substeps, float h, float half_h,
              float h_sixth) {
  extern __shared__ float smem[];  // obs (n_ds, n_obs), then s0 (n_ds)
  float* obs_s = smem;
  float* s0_s = smem + n_ds * n_obs;
  for (int i = threadIdx.x; i < n_ds * n_obs; i += blockDim.x)
    obs_s[i] = obs[i];
  for (int i = threadIdx.x; i < n_ds; i += blockDim.x) s0_s[i] = s0[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;  // ragged tail: masked, not padded
  const float* th = theta + static_cast<size_t>(p) * 3;
  const float vmax = th[0];
  const float km = th[1];
  const float sig = th[2];

  float total = 0.0f;
  for (int ds = 0; ds < n_ds; ++ds) {
    const float s0v = s0_s[ds];
    const float* o = obs_s + ds * n_obs;
    float s = s0v;
    const float r0 = o[0] - (s0v - s);
    float acc = 0.0f + r0 * r0;
    for (int i = 1; i < n_obs; ++i) {
      for (int j = 0; j < substeps; ++j) {
        const float k1 = mm_rate(vmax, km, s);
        const float k2 = mm_rate(vmax, km, s + half_h * k1);
        const float k3 = mm_rate(vmax, km, s + half_h * k2);
        const float k4 = mm_rate(vmax, km, s + h * k3);
        s = s + h_sixth * (((k1 + 2.0f * k2) + 2.0f * k3) + k4);
      }
      const float r = o[i] - (s0v - s);
      acc = acc + r * r;
    }
    total = ds == 0 ? acc : total + acc;
  }

  const float sigma = nan_max(sig, 1e-12f);
  const float out = (-0.5f * n_obs * n_ds) * (kLog2Pi + 2.0f * logf(sigma)) -
                    total / (2.0f * sigma * sigma);
  const bool bad = (sig <= 0.0f) || (out != out);
  ll[p] = bad ? -INFINITY : out;
}

}  // namespace

// theta (n, 3), obs (n_ds, n_obs), s0 (n_ds) -> ll (n); all float32,
// contiguous, on the device of `stream`. h = dt / substeps, half_h = 0.5 h
// and h_sixth = h / 6, each computed in double by the caller.
extern "C" int mm_rk4_launch(const float* theta, const float* obs,
                             const float* s0, float* ll, int n, int n_ds,
                             int n_obs, int substeps, float h, float half_h,
                             float h_sixth, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(n_ds * n_obs + n_ds) * sizeof(float);
  mm_rk4_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      theta, obs, s0, ll, n, n_ds, n_obs, substeps, h, half_h, h_sixth);
  return static_cast<int>(cudaGetLastError());
}
