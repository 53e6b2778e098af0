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
// One departure: after every step a state below FLT_MIN in magnitude is
// set to 0. A state that small never reaches the likelihood: s0 - S is s0
// (the smallest s0 of the model's data is 0.1, whose half ulp is 3.7e-9),
// so ll keeps its bits, while a subnormal operand would send every later
// IEEE division down its slow path (S falls that low on prior draws with
// Vmax/Km above about 9).
//
// What bounds it on the H100: operations. A particle does
// n_ds (n_obs - 1) substeps RK4 steps, each a chain of four dependent
// divisions, and moves 16 bytes (theta in, ll out).
//
// What the design does about it:
// - The datasets advance side by side in one thread: each thread keeps S
//   and the residual sum of all n_ds trajectories in registers and takes
//   every RK4 stage for all of them before the next, so the scheduler has
//   n_ds independent chains per warp to overlap (the TPU kernel carried the
//   datasets as one leading axis, too). n_ds = 6 (MM) and 5 are template
//   instances; any other count marches one dataset at a time. The order of
//   the operations within a dataset and of the final sum over datasets is
//   unchanged. On the H100 this was 4-12% faster than one dataset at a
//   time (unlike mm_exact's, whose chains are shorter).
// - The divisions have no branch (div_rn.cuh). An IEEE division ends in a
//   range check and a branch to its slow path, and the scheduler overlaps
//   nothing across that branch; div_rn runs the same reciprocal sequence, checks
//   the range itself and leaves a flag per trajectory; one branch per RK4
//   step redoes the step with IEEE division for the trajectories whose flag
//   is down (Km + S near 0, huge operands; a NaN trajectory is NaN either
//   way and is left as it is). The result has the bits of IEEE division,
//   except as mm_rate says, where ll cannot see it.
// - No subnormal state (above).
// - obs and s0 sit in shared memory, read by all threads of a block at the
//   same address (a broadcast). An ensemble's populations ride grid.y: block
//   (x, b) marches particles of population b against b's own obs and s0,
//   so one launch covers all of them, as Pallas's batching rule makes the
//   population a grid axis of the TPU kernel under vmap. The TPU kernel's (1, block) lane blocks, its
//   static unroll over the grid and its padding of the particle axis with
//   ones were layout artefacts of that machine and are dropped: the time
//   loop is a loop, and the ragged tail is masked.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "div_rn.cuh"

namespace {

constexpr int kThreads = 256;

constexpr float kLog2Pi = static_cast<float>(1.8378770664093453);

// max that keeps a NaN, as jnp.maximum does (fmaxf drops it).
__device__ __forceinline__ float nan_max(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// Vmax S / (Km + S), negated. div_rn (FAST) leaves a numerator below 2^-66
// unflagged, and the quotient can then end one ulp off, and with it the
// last bit of S; that takes |S| < 2^-28, where s0 - S is s0 for every s0 of
// the data, or Vmax < 2^-38, where a step moves S by less than Vmax h / Km
// of itself.
template <bool FAST>
__device__ __forceinline__ float mm_rate(float vmax, float km, float s,
                                         bool& ok) {
  return divide<FAST>(-vmax * s, km + s, ok);
}

// One RK4 step of the D trajectories s of one thread into sn, stage by
// stage. FAST: branch-free divisions that clear ok[d] where they cannot
// vouch for the bits of trajectory d; otherwise IEEE division.
template <int D, bool FAST>
__device__ __forceinline__ void rk4_step(const float (&s)[D], float (&sn)[D],
                                         float vmax, float km, float h,
                                         float half_h, float h_sixth,
                                         bool (&ok)[D]) {
  float k1[D], k2[D], k3[D], k4[D];
#pragma unroll
  for (int d = 0; d < D; ++d) k1[d] = mm_rate<FAST>(vmax, km, s[d], ok[d]);
#pragma unroll
  for (int d = 0; d < D; ++d)
    k2[d] = mm_rate<FAST>(vmax, km, s[d] + half_h * k1[d], ok[d]);
#pragma unroll
  for (int d = 0; d < D; ++d)
    k3[d] = mm_rate<FAST>(vmax, km, s[d] + half_h * k2[d], ok[d]);
#pragma unroll
  for (int d = 0; d < D; ++d)
    k4[d] = mm_rate<FAST>(vmax, km, s[d] + h * k3[d], ok[d]);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    sn[d] = s[d] + h_sixth * (((k1[d] + 2.0f * k2[d]) + 2.0f * k3[d]) +
                              k4[d]);
    sn[d] = fabsf(sn[d]) < FLT_MIN ? 0.0f : sn[d];  // no subnormal state
  }
}

// The step again with IEEE division for every trajectory d whose ok[d] is
// down: a NaN state stays NaN either way and is left as it is (rows with a
// NaN parameter, or whose fixed-step march blew up).
template <int D>
__device__ __forceinline__ void redo_ieee(const float (&s)[D], float (&sn)[D],
                                          float vmax, float km, float h,
                                          float half_h, float h_sixth,
                                          const bool (&ok)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (ok[d] || s[d] != s[d]) continue;
    const float s1[1] = {s[d]};
    float sn1[1];
    bool ok1[1] = {true};
    rk4_step<1, false>(s1, sn1, vmax, km, h, half_h, h_sixth, ok1);
    sn[d] = sn1[0];
  }
}

// The residual sums of D datasets (obs rows obs[d * n_obs ...], initial
// substrates s0[d]) for one particle.
template <int D>
__device__ __forceinline__ void march(const float* obs, const float* s0,
                                      int n_obs, int substeps, float vmax,
                                      float km, float h, float half_h,
                                      float h_sixth, float (&acc)[D]) {
  float s0v[D], s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    s0v[d] = s0[d];
    s[d] = s0v[d];
    const float r0 = obs[d * n_obs] - (s0v[d] - s[d]);
    acc[d] = 0.0f + r0 * r0;
  }
  for (int i = 1; i < n_obs; ++i) {
    for (int j = 0; j < substeps; ++j) {
      float sn[D];
      bool ok[D], all = true;
#pragma unroll
      for (int d = 0; d < D; ++d) ok[d] = true;
      rk4_step<D, true>(s, sn, vmax, km, h, half_h, h_sixth, ok);
#pragma unroll
      for (int d = 0; d < D; ++d) all = all & ok[d];
      if (!all) redo_ieee<D>(s, sn, vmax, km, h, half_h, h_sixth, ok);
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = sn[d];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float r = obs[d * n_obs + i] - (s0v[d] - s[d]);
      acc[d] = acc[d] + r * r;
    }
  }
}

// NDS > 0: exactly NDS datasets, side by side; NDS == 0: any n_ds, one
// dataset after another.
template <int NDS>
__global__ void __launch_bounds__(kThreads)
mm_rk4_kernel(const float* __restrict__ theta, const float* __restrict__ obs,
              const float* __restrict__ s0, float* __restrict__ ll, int n,
              int n_ds, int n_obs, int substeps, float h, float half_h,
              float h_sixth) {
  extern __shared__ float smem[];  // obs (n_ds, n_obs), then s0 (n_ds)
  float* obs_s = smem;
  float* s0_s = smem + n_ds * n_obs;
  const size_t b = blockIdx.y;  // population
  for (int i = threadIdx.x; i < n_ds * n_obs; i += blockDim.x)
    obs_s[i] = obs[b * n_ds * n_obs + i];
  for (int i = threadIdx.x; i < n_ds; i += blockDim.x)
    s0_s[i] = s0[b * n_ds + i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;  // ragged tail: masked, not padded
  const float* th = theta + (b * n + p) * 3;
  const float vmax = th[0];
  const float km = th[1];
  const float sig = th[2];

  float total = 0.0f;
  if constexpr (NDS > 0) {
    float acc[NDS];
    march<NDS>(obs_s, s0_s, n_obs, substeps, vmax, km, h, half_h, h_sixth,
               acc);
    total = acc[0];
#pragma unroll
    for (int d = 1; d < NDS; ++d) total = total + acc[d];
  } else {
    for (int ds = 0; ds < n_ds; ++ds) {
      float acc[1];
      march<1>(obs_s + ds * n_obs, s0_s + ds, n_obs, substeps, vmax, km, h,
               half_h, h_sixth, acc);
      total = ds == 0 ? acc[0] : total + acc[0];
    }
  }

  const float sigma = nan_max(sig, 1e-12f);
  const float out = (-0.5f * n_obs * n_ds) * (kLog2Pi + 2.0f * logf(sigma)) -
                    total / (2.0f * sigma * sigma);
  const bool bad = (sig <= 0.0f) || (out != out);
  ll[b * n + p] = bad ? -INFINITY : out;
}

template <int NDS>
void launch(const float* theta, const float* obs, const float* s0, float* ll,
            int b, int n, int n_ds, int n_obs, int substeps, float h,
            float half_h, float h_sixth, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  const size_t smem = static_cast<size_t>(n_ds * n_obs + n_ds) * sizeof(float);
  mm_rk4_kernel<NDS><<<grid, kThreads, smem, stream>>>(
      theta, obs, s0, ll, n, n_ds, n_obs, substeps, h, half_h, h_sixth);
}

}  // namespace

// theta (b, n, 3), obs (b, n_ds, n_obs), s0 (b, n_ds) -> ll (b, n); all
// float32, contiguous, on the device of `stream`; b <= 65535. h = dt /
// substeps, half_h = 0.5 h and h_sixth = h / 6, each computed in double by
// the caller.
extern "C" int mm_rk4_launch(const float* theta, const float* obs,
                             const float* s0, float* ll, int b, int n,
                             int n_ds, int n_obs, int substeps, float h,
                             float half_h, float h_sixth, void* stream) {
  if (b == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_ds) {
    case 6:
      launch<6>(theta, obs, s0, ll, b, n, n_ds, n_obs, substeps, h, half_h,
                h_sixth, st);
      break;
    case 5:
      launch<5>(theta, obs, s0, ll, b, n, n_ds, n_obs, substeps, h, half_h,
                h_sixth, st);
      break;
    default:
      launch<0>(theta, obs, s0, ll, b, n, n_ds, n_obs, substeps, h, half_h,
                h_sixth, st);
  }
  return static_cast<int>(cudaGetLastError());
}
