// Block-Thomas factorization of a block-tridiagonal system, per lane:
//   LU_0 = lu(B_0),  m_i = A_i LU_{i-1}^{-1},  LU_i = lu(B_i - m_i C_{i-1}),
// no-pivot Doolittle LU of 7x7 blocks, m_0 = 0. Arrays are (NX, 7, CS, nb)
// float32 with the lane axis last; CS is 7, or 8 with a zero eighth column.
//
// Replaces: smc_tpu/ops/thomas_pallas.py, _factor_kernel (with _factor_row
// and _lu_cols), the Pallas TPU kernel behind block_thomas_factor_pl. The
// TPU kernel is one program over the whole batch that streams grid rows
// through double-buffered VMEM windows with manual DMAs and semaphores, and
// pads the blocks 7 -> 8 columns so the row DMAs are sublane-aligned. Here
// lanes are independent systems: one thread owns one lane and walks the NX
// recurrence in a loop, with the 7x7 algebra unrolled over compile-time
// indices so that LU_{i-1} and the new block live in registers.
//
// What bounds it on the H100: bytes. Five arrays of NX*49 floats per lane
// (about 50 KB per lane at NX = 51) against about 800 fp32 instructions
// per grid row. The march's B = 15,360 lanes are 480 warps, under four per
// SM, so the device memory is kept busy only if each warp has a row's bytes
// in flight while it computes; loads issued ahead into registers cannot do
// that (the blocks already hold about 100 of them).
//
// What the design does about it: a block owns a tile of kLanes lanes, one
// thread per lane, and stages the rows through a ring of kStages stages in
// shared memory (ring.cuh). A stage holds B_i, A_i and C_{i-1} of the
// thread's lane, copied with cp.async kStages - 1 rows ahead of the
// arithmetic, which reads them from the thread's own bank in the order
// _factor_row spends them: each row r of m_i is solved on its own from row
// r of A_i (w U = A_i, then m L = w), stored, and spent at once on row r of
// B_i - m_i C_{i-1}, so A_i and m_i are never held whole. LU_i and m_i go
// out as coalesced 4-byte stores, lane after lane. The copies pass through
// L1, so the SM keeps kCarveout percent of its L1 and shared memory as
// shared memory and the rest as L1 (196 KB and 60 KB): at the default
// split, 228 KB of shared memory, 28 KB of L1 held the bytes in flight
// below what the device memory needs.
//
// Operation order follows _factor_row and _lu_cols (reciprocal, then
// multiply, for the pivots); nvcc contracts a*b + c into FMAs, so results
// differ from the plain PyTorch version in the last bits. There is no
// pivoting and no guard: a zero pivot gives inf/NaN in that lane only, and
// the caller's failure sentinel rejects that particle.
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int NF = 7;
constexpr int NB = NF * NF;
constexpr int kLanes = 32;     // lanes (threads) per block
constexpr int kStages = 2;     // rows in the ring
constexpr int kCarveout = 85;  // percent of L1 + shared kept as shared
constexpr int kSlot = 3 * NB;  // floats per lane and stage: B_i, A_i, C_{i-1}
constexpr size_t kSmem = sizeof(float) * kStages * kSlot * kLanes;

bool smem_set[2][64];          // per column stride and device

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

// Copy grid row i of this lane into stage `st`: B_i (entries 0-48) and, for
// i >= 1, A_i (49-97) and C_{i-1} (98-146).
template <int CS>
__device__ __forceinline__ void issue(float* st, int i, int nx, size_t snb,
                                      const float* A, const float* B,
                                      const float* C) {
  if (i < nx) {
    const size_t row = static_cast<size_t>(NF) * CS * snb;
#pragma unroll
    for (int r = 0; r < NF; ++r)
#pragma unroll
      for (int c = 0; c < NF; ++c)
        ring::copy4(st + (r * NF + c) * kLanes, B + i * row + (r * CS + c) * snb);
    if (i > 0) {
#pragma unroll
      for (int r = 0; r < NF; ++r)
#pragma unroll
        for (int c = 0; c < NF; ++c) {
          const size_t e = (r * CS + c) * snb;
          ring::copy4(st + (NB + r * NF + c) * kLanes, A + i * row + e);
          ring::copy4(st + (2 * NB + r * NF + c) * kLanes,
                      C + (i - 1) * row + e);
        }
    }
  }
  ring::commit();
}

template <int CS>
__global__ void __launch_bounds__(kLanes)
thomas_factor_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ C, float* __restrict__ LU,
                     float* __restrict__ Ms, int nx, int nb) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= nb) return;
  const size_t snb = static_cast<size_t>(nb);
  const size_t row = static_cast<size_t>(NF) * CS * snb;  // one grid row
  // Offset of block entry (r, c) of this lane within a grid row, once the
  // global arrays are offset to the lane.
  auto at = [&](int r, int c) { return static_cast<size_t>(r * CS + c) * snb; };
  A += lane, B += lane, C += lane, LU += lane, Ms += lane;
  float* base = smem + threadIdx.x;   // entry e of stage s: [(s*kSlot+e)*kLanes]

  int wr = 0;
  for (int i = 0; i < kStages - 1; ++i, ++wr)
    issue<CS>(base + wr * kSlot * kLanes, i, nx, snb, A, B, C);

  float lu[NF][NF];
  int rd = 0;
#pragma unroll 1
  for (int i = 0; i < nx; ++i) {
    issue<CS>(base + wr * kSlot * kLanes, i + kStages - 1, nx, snb, A, B, C);
    wr = wr + 1 == kStages ? 0 : wr + 1;
    ring::wait<kStages - 1>();                 // row i has landed
    const float* s = base + rd * kSlot * kLanes;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    auto sB = [&](int r, int c) { return s[(r * NF + c) * kLanes]; };
    auto sA = [&](int r, int c) { return s[(NB + r * NF + c) * kLanes]; };
    auto sC = [&](int r, int c) { return s[(2 * NB + r * NF + c) * kLanes]; };
    float* LUi = LU + i * row;
    float* Mi = Ms + i * row;

    if (i == 0) {
#pragma unroll
      for (int r = 0; r < NF; ++r)
#pragma unroll
        for (int c = 0; c < NF; ++c) lu[r][c] = sB(r, c);
      lu_inplace(lu);
#pragma unroll
      for (int r = 0; r < NF; ++r) {
#pragma unroll
        for (int c = 0; c < NF; ++c) LUi[at(r, c)] = lu[r][c];
#pragma unroll
        for (int c = NF; c < CS; ++c) LUi[at(r, c)] = 0.0f;   // the pad column
#pragma unroll
        for (int c = 0; c < CS; ++c) Mi[at(r, c)] = 0.0f;
      }
      continue;
    }

    float inv[NF];
#pragma unroll
    for (int c = 0; c < NF; ++c) inv[c] = 1.0f / lu[c][c];

    float bp[NF][NF];
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      float w[NF], m[NF];
#pragma unroll
      for (int c = 0; c < NF; ++c) {          // w U = A, columns ascending
        float acc = sA(r, c);
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
        float acc = sB(r, j);
#pragma unroll
        for (int k = 0; k < NF; ++k) acc = acc - m[k] * sC(k, j);
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
  ring::wait<0>();
}

template <int CS>
int launch(const float* A, const float* B, const float* C, float* LU,
           float* Ms, int nx, int nb, cudaStream_t s) {
  cudaError_t err = ring::allow_smem(thomas_factor_kernel<CS>,
                                     kCarveout, smem_set[CS - NF]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (nb + kLanes - 1) / kLanes;
  thomas_factor_kernel<CS><<<blocks, kLanes, kSmem, s>>>(A, B, C, LU, Ms, nx,
                                                         nb);
  return static_cast<int>(cudaGetLastError());
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
  return cs == 7 ? launch<7>(A, B, C, LU, Ms, nx, nb, s)
                 : launch<8>(A, B, C, LU, Ms, nx, nb, s);
}

// Registers, shared bytes per block, resident blocks per SM and spilled
// bytes of the kernel behind the column stride `cs` (7 or 8) into out[0..3];
// lanes per block into out[4]. `nx` is taken for the apply's signature: the
// factor's shared memory does not depend on it.
extern "C" int thomas_factor_info(int cs, int nx, int* out) {
  if ((cs != 7 && cs != 8) || nx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  out[4] = kLanes;
  return static_cast<int>(
      cs == 7 ? ring::info(thomas_factor_kernel<7>, kLanes, kSmem, kCarveout,
                           smem_set[0], out)
              : ring::info(thomas_factor_kernel<8>, kLanes, kSmem, kCarveout,
                           smem_set[1], out));
}
