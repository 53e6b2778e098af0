// Block-Thomas factorization of a block-tridiagonal system, per lane:
//   LU_0 = lu(B_0),  m_i = A_i LU_{i-1}^{-1},  LU_i = lu(B_i - m_i C_{i-1}),
// no-pivot Doolittle LU of 7x7 blocks, m_0 = 0. Arrays are (NX, 7, CS, nb)
// float32 with the lane axis last; CS is 7, or 8 with a zero eighth column.
//
// Replaces: smc_tpu/ops/thomas_pallas.py, _factor_kernel (with _factor_row
// and _lu_cols), the Pallas TPU kernel behind block_thomas_factor_pl. The
// TPU kernel is one program over the whole batch that streams grid rows
// through double-buffered VMEM windows with manual DMAs and semaphores, and
// pads the blocks 7 -> 8 columns so the row DMAs are sublane-aligned. None
// of that is carried over. Lanes are independent systems, so here one
// thread owns one lane and walks the NX recurrence in a loop; the 7x7
// algebra is unrolled over compile-time indices so the blocks live in
// registers. Element [i, r, c, lane] of neighbouring threads is contiguous,
// so every load and store is coalesced without shared memory.
//
// What bounds it on the H100: bytes. Five arrays of NX*49 floats per lane
// (about 50 KB per lane at NX = 51) against about 750 FMAs per grid row.
//
// What the design does about it: every input is read once and every output
// written once, nothing is staged in shared memory, and the loads of row i
// do not depend on the recurrence, so they can be issued ahead of the
// arithmetic. Registers are the scarce resource (LU_prev 49, the new block
// 49, C_{i-1} 49): the row is staged as _factor_row stages it. Each row r
// of m_i is solved on its own from row r of A_i (w U = A_i, then m L = w),
// stored, and spent at once on row r of B_i - m_i C_{i-1}, so A_i and m_i
// are never held whole.
//
// Operation order follows _factor_row and _lu_cols (reciprocal, then
// multiply, for the pivots); nvcc contracts a*b + c into FMAs, so results
// differ from the plain PyTorch version in the last bits. There is no
// pivoting and no guard: a zero pivot gives inf/NaN in that lane only, and
// the caller's failure sentinel rejects that particle.
#include <cuda_runtime.h>

namespace {

constexpr int NF = 7;
constexpr int kThreads = 64;   // B = 15,360 lanes is 240 blocks on 132 SMs

// In-place no-pivot Doolittle LU: unit-lower L below the diagonal, U on and
// above it.
__device__ __forceinline__ void lu_inplace(float (&M)[NF][NF]) {
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    const float inv = 1.0f / M[c][c];
#pragma unroll
    for (int r = c + 1; r < NF; ++r) {
      const float f = M[r][c] * inv;
      M[r][c] = f;
#pragma unroll
      for (int j = c + 1; j < NF; ++j) M[r][j] = M[r][j] - f * M[c][j];
    }
  }
}

template <int CS>
__global__ void __launch_bounds__(kThreads)
thomas_factor_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ C, float* __restrict__ LU,
                     float* __restrict__ Ms, int nx, int nb) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= nb) return;
  const size_t snb = static_cast<size_t>(nb);
  const size_t row = static_cast<size_t>(NF) * CS * snb;  // one grid row
  // Offset of block entry (r, c) of this lane within a grid row.
  auto at = [&](int r, int c) {
    return static_cast<size_t>(r * CS + c) * snb + lane;
  };

  float lu[NF][NF];
#pragma unroll
  for (int r = 0; r < NF; ++r)
#pragma unroll
    for (int c = 0; c < NF; ++c) lu[r][c] = B[at(r, c)];
  lu_inplace(lu);
#pragma unroll
  for (int r = 0; r < NF; ++r) {
#pragma unroll
    for (int c = 0; c < NF; ++c) LU[at(r, c)] = lu[r][c];
#pragma unroll
    for (int c = NF; c < CS; ++c) LU[at(r, c)] = 0.0f;   // the pad column
#pragma unroll
    for (int c = 0; c < CS; ++c) Ms[at(r, c)] = 0.0f;
  }

  for (int i = 1; i < nx; ++i) {
    const float* Ai = A + i * row;
    const float* Bi = B + i * row;
    const float* Cp = C + (i - 1) * row;
    float* LUi = LU + i * row;
    float* Mi = Ms + i * row;

    float inv[NF];
#pragma unroll
    for (int c = 0; c < NF; ++c) inv[c] = 1.0f / lu[c][c];

    float bp[NF][NF];
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      float w[NF], m[NF];
#pragma unroll
      for (int c = 0; c < NF; ++c) {          // w U = A, columns ascending
        float acc = Ai[at(r, c)];
#pragma unroll
        for (int k = 0; k < c; ++k) acc = acc - w[k] * lu[k][c];
        w[c] = acc * inv[c];
      }
#pragma unroll
      for (int c = NF - 1; c >= 0; --c) {     // m L = w, columns descending
        float acc = w[c];
#pragma unroll
        for (int k = c + 1; k < NF; ++k) acc = acc - m[k] * lu[k][c];
        m[c] = acc;
      }
#pragma unroll
      for (int c = 0; c < NF; ++c) Mi[at(r, c)] = m[c];
#pragma unroll
      for (int c = NF; c < CS; ++c) Mi[at(r, c)] = 0.0f;
#pragma unroll
      for (int j = 0; j < NF; ++j) {          // row r of B - m C_prev
        float acc = Bi[at(r, j)];
#pragma unroll
        for (int k = 0; k < NF; ++k) acc = acc - m[k] * Cp[at(k, j)];
        bp[r][j] = acc;
      }
    }
    lu_inplace(bp);
#pragma unroll
    for (int r = 0; r < NF; ++r) {
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        lu[r][c] = bp[r][c];
        LUi[at(r, c)] = bp[r][c];
      }
#pragma unroll
      for (int c = NF; c < CS; ++c) LUi[at(r, c)] = 0.0f;
    }
  }
}

}  // namespace

// A, B, C (nx, 7, cs, nb) -> LU, Ms (nx, 7, cs, nb), cs 7 or 8. All float32,
// contiguous, on the device of `stream`. A[0] and C[nx-1] are not read.
extern "C" int thomas_factor_launch(const float* A, const float* B,
                                    const float* C, float* LU, float* Ms,
                                    int nx, int nb, int cs, void* stream) {
  if (nx < 1 || nb < 1 || (cs != 7 && cs != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (nb + kThreads - 1) / kThreads;
  if (cs == 7)
    thomas_factor_kernel<7><<<blocks, kThreads, 0, s>>>(A, B, C, LU, Ms, nx,
                                                        nb);
  else
    thomas_factor_kernel<8><<<blocks, kThreads, 0, s>>>(A, B, C, LU, Ms, nx,
                                                        nb);
  return static_cast<int>(cudaGetLastError());
}
