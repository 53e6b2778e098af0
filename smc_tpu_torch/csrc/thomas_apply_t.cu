// Block-Thomas solve of the TRANSPOSED system with stored factors, per lane:
//   M^T lam = g,  M = L U  (L: identity diagonal, m_i below it; U: D_i on
//   the diagonal, the matrix LU_i factors, and C_i above it), so
//   z_0 = D_0^-T g_0,  z_i = D_i^-T (g_i - C_{i-1}^T z_{i-1});
//   lam_last = z_last, lam_i = z_i - m_{i+1}^T lam_{i+1}.
// Factors LU, Ms, C are (NX, 7, CS, nb) float32 as the factor kernel
// (thomas_factor.cu) writes them, g and lam (NX, 7, nb), the lane axis last.
//
// What it is for: the backward pass of the block-Thomas solve. For
// x = M^-1 r the vector-Jacobian product is lam = M^-T x_bar, which is the
// rhs's cotangent, and the blocks' cotangents are outer products of lam
// with x (ops/thomas_cuda.py). The TPU package has no such kernel: jax.grad
// differentiates its XLA scan of the factor and the apply instead.
//
// What bounds it on the H100: bytes, as for the apply (thomas_apply.cu):
// three factor arrays of NX*49 floats per lane plus g and lam, against
// about 170 fp32 instructions per grid row, on a serial chain of 2 NX - 1
// rows per lane.
//
// What the design does about it: the apply kernel's, with the sweeps
// turned round. A block owns a tile of kLanes lanes, one thread per lane,
// and stages the rows of its sweep through a ring of kStages stages in
// shared memory (ring.cuh), each thread copying its own lane's entries
// with cp.async, kStages - 1 rows ahead of its arithmetic. The forward
// sweep needs g_i, LU_i and C_{i-1} of row i; the backward sweep needs
// m_{i+1}, in falling row order, so the ring is fed upward through the
// rows and then downward, and the backward rows are issued during the last
// forward rows. z (NX*7 floats per lane) stays in shared memory behind the
// ring where two tiles of it fit in an SM (NX <= kZSharedRows), so lam is
// written once; at larger NX it goes to lam on the way forward and is read
// back a row ahead of its use on the way back.
//
// Operation order follows lu7_solve_T of ops/dae_fast.py (reciprocal, then
// multiply, for the pivots); nvcc contracts a*b + c into FMAs, so results
// differ from the plain PyTorch version in the last bits. A zero pivot
// gives inf/NaN in that lane only; nothing is guarded.
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int NF = 7;
constexpr int NB = NF * NF;
constexpr int kLanes = 32;     // lanes (threads) per block
constexpr int kStages = 3;     // rows in the ring
constexpr int kCarveout = 85;  // percent of L1 + shared kept as shared
// Floats per lane and stage: g_i, LU_i and C_{i-1} on the way forward,
// m_{i+1} (in the LU slot) on the way back.
constexpr int kG = 0, kLU = NF, kC = NF + NB;
constexpr int kSlot = NF + 2 * NB;
constexpr int kZSharedRows = 64;    // up to here z stays in shared memory

constexpr size_t smem_bytes(int nx, bool z_shared) {
  return sizeof(float) * kLanes *
         (kStages * kSlot + (z_shared ? static_cast<size_t>(nx) * NF : 0));
}
static_assert(2 * (smem_bytes(kZSharedRows, true) + 1024) <= 196 * 1024,
              "z of kZSharedRows rows leaves room for two tiles per SM");

bool smem_set[2][2][64];       // per column stride, z placement and device

// Copy step k of this lane into stage `st`: forward row i = k < nx as g_i,
// LU_i and (i > 0) C_{i-1}; backward row i = 2 nx - 2 - k as m_{i+1}.
template <int CS>
__device__ __forceinline__ void issue(float* st, int k, int nx, size_t snb,
                                      const float* LU, const float* Ms,
                                      const float* C, const float* g) {
  const size_t frow = static_cast<size_t>(NF) * CS * snb;
  if (k < nx) {
    const float* gk = g + k * NF * snb;
#pragma unroll
    for (int e = 0; e < NF; ++e)
      ring::copy4(st + (kG + e) * kLanes, gk + e * snb);
    const float* lu = LU + k * frow;
#pragma unroll
    for (int r = 0; r < NF; ++r)
#pragma unroll
      for (int c = 0; c < NF; ++c)
        ring::copy4(st + (kLU + r * NF + c) * kLanes, lu + (r * CS + c) * snb);
    if (k > 0) {
      const float* cc = C + (k - 1) * frow;
#pragma unroll
      for (int r = 0; r < NF; ++r)
#pragma unroll
        for (int c = 0; c < NF; ++c)
          ring::copy4(st + (kC + r * NF + c) * kLanes,
                      cc + (r * CS + c) * snb);
    }
  } else if (k < 2 * nx - 1) {
    const float* m = Ms + (2 * nx - 1 - k) * frow;     // m_{i+1}
#pragma unroll
    for (int r = 0; r < NF; ++r)
#pragma unroll
      for (int c = 0; c < NF; ++c)
        ring::copy4(st + (kLU + r * NF + c) * kLanes, m + (r * CS + c) * snb);
  }
  ring::commit();
}

template <int CS, bool ZShared>
__global__ void __launch_bounds__(kLanes)
thomas_apply_t_kernel(const float* __restrict__ LU,
                      const float* __restrict__ Ms,
                      const float* __restrict__ C, const float* __restrict__ g,
                      float* __restrict__ lam, int nx, int nb) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= nb) return;
  const size_t snb = static_cast<size_t>(nb);
  const size_t vrow = static_cast<size_t>(NF) * snb;  // a vector row
  float* base = smem + threadIdx.x;
  float* zs = base + kStages * kSlot * kLanes;   // z_i[r] at (i*NF+r)*kLanes
  LU += lane, Ms += lane, C += lane, g += lane, lam += lane;

  int wr = 0;
  for (int k = 0; k < kStages - 1; ++k, ++wr)
    issue<CS>(base + wr * kSlot * kLanes, k, nx, snb, LU, Ms, C, g);

  float v[NF], z[NF];
  int rd = 0;
#pragma unroll 1
  for (int k = 0; k < 2 * nx - 1; ++k) {
    issue<CS>(base + wr * kSlot * kLanes, k + kStages - 1, nx, snb, LU, Ms,
              C, g);
    wr = wr + 1 == kStages ? 0 : wr + 1;
    ring::wait<kStages - 1>();                 // step k has landed
    const float* s = base + rd * kSlot * kLanes;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    auto at = [&](int e) { return s[e * kLanes]; };

    if (k < nx) {
      // ---- forward: z_k = D_k^-T (g_k - C_{k-1}^T z_{k-1}) ---------------
      if (k == 0) {
#pragma unroll
        for (int r = 0; r < NF; ++r) v[r] = at(kG + r);
      } else {
        float t[NF];
#pragma unroll
        for (int r = 0; r < NF; ++r) {
          float acc = at(kC + r) * v[0];                    // C[0][r]
#pragma unroll
          for (int c = 1; c < NF; ++c) acc = acc + at(kC + c * NF + r) * v[c];
          t[r] = at(kG + r) - acc;
        }
#pragma unroll
        for (int r = 0; r < NF; ++r) v[r] = t[r];
      }
      // U^T y = t (lower triangular, U's diagonal), then L^T z = y (unit
      // upper triangular), in place.
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        v[c] = v[c] * (1.0f / at(kLU + c * NF + c));
#pragma unroll
        for (int r = c + 1; r < NF; ++r) v[r] = v[r] - at(kLU + c * NF + r) * v[c];
      }
#pragma unroll
      for (int c = NF - 1; c >= 0; --c) {
        float acc = v[c];
#pragma unroll
        for (int cc = c + 1; cc < NF; ++cc)
          acc = acc - at(kLU + cc * NF + c) * v[cc];
        v[c] = acc;
      }
      if (k < nx - 1) {                        // the last z stays in v
#pragma unroll
        for (int r = 0; r < NF; ++r) {
          if (ZShared)
            zs[(k * NF + r) * kLanes] = v[r];
          else
            lam[k * vrow + r * snb] = v[r];
        }
      } else {
#pragma unroll
        for (int r = 0; r < NF; ++r) lam[k * vrow + r * snb] = v[r];
        if (!ZShared && nx > 1) {              // z_{nx-2}, a row ahead
#pragma unroll
          for (int r = 0; r < NF; ++r) z[r] = lam[(k - 1) * vrow + r * snb];
        }
      }
    } else {
      // ---- backward: lam_i = z_i - m_{i+1}^T lam_{i+1} -------------------
      const int i = 2 * nx - 2 - k;
      float t[NF];
#pragma unroll
      for (int r = 0; r < NF; ++r) {
        float acc = at(kLU + r) * v[0];                     // m[0][r]
#pragma unroll
        for (int c = 1; c < NF; ++c) acc = acc + at(kLU + c * NF + r) * v[c];
        t[r] = (ZShared ? zs[(i * NF + r) * kLanes] : z[r]) - acc;
      }
#pragma unroll
      for (int r = 0; r < NF; ++r) {
        v[r] = t[r];
        lam[i * vrow + r * snb] = v[r];
      }
      if (!ZShared && i > 0) {                 // z_{i-1}, a row ahead
#pragma unroll
        for (int r = 0; r < NF; ++r) z[r] = lam[(i - 1) * vrow + r * snb];
      }
    }
  }
  ring::wait<0>();
}

template <int CS, bool ZShared>
cudaError_t launch_z(const float* LU, const float* Ms, const float* C,
                     const float* g, float* lam, int nx, int nb,
                     cudaStream_t stream) {
  const cudaError_t err = ring::allow_smem(thomas_apply_t_kernel<CS, ZShared>,
                                           kCarveout,
                                           smem_set[CS - NF][ZShared]);
  if (err != cudaSuccess) return err;
  const int blocks = (nb + kLanes - 1) / kLanes;
  thomas_apply_t_kernel<CS, ZShared>
      <<<blocks, kLanes, smem_bytes(nx, ZShared), stream>>>(LU, Ms, C, g,
                                                            lam, nx, nb);
  return cudaGetLastError();
}

template <int CS>
int launch(const float* LU, const float* Ms, const float* C, const float* g,
           float* lam, int nx, int nb, void* stream) {
  if (nx < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      nx <= kZSharedRows ? launch_z<CS, true>(LU, Ms, C, g, lam, nx, nb, s)
                         : launch_z<CS, false>(LU, Ms, C, g, lam, nx, nb, s));
}

template <int CS>
int info(int nx, int* out) {
  const bool zsh = nx <= kZSharedRows;
  return static_cast<int>(
      zsh ? ring::info(thomas_apply_t_kernel<CS, true>, kLanes,
                       smem_bytes(nx, true), kCarveout, smem_set[CS - NF][1],
                       out)
          : ring::info(thomas_apply_t_kernel<CS, false>, kLanes,
                       smem_bytes(nx, false), kCarveout, smem_set[CS - NF][0],
                       out));
}

}  // namespace

// Factors (nx, 7, cs, nb) with cs 7 or 8 (a zero eighth column, never
// read), g (nx, 7, nb) -> lam (nx, 7, nb). All float32, contiguous, on the
// device of `stream`.
extern "C" int thomas_apply_t_launch(const float* LU, const float* Ms,
                                     const float* C, const float* g,
                                     float* lam, int nx, int nb, int cs,
                                     void* stream) {
  if (cs == 7) return launch<7>(LU, Ms, C, g, lam, nx, nb, stream);
  if (cs == 8) return launch<8>(LU, Ms, C, g, lam, nx, nb, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, shared bytes per block, resident blocks per SM and spilled
// bytes of the kernel that a launch at `nx` grid rows and column stride
// `cs` runs, into out[0..3]; lanes per block into out[4].
extern "C" int thomas_apply_t_info(int cs, int nx, int* out) {
  if ((cs != 7 && cs != 8) || nx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  out[4] = kLanes;
  return cs == 7 ? info<7>(nx, out) : info<8>(nx, out);
}
