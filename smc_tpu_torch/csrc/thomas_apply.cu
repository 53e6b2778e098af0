// Block-Thomas solve with stored factors, per lane:
//   rp_0 = r_0,  rp_i = r_i - m_i rp_{i-1};
//   x_last = LU_last^{-1} rp_last,  x_i = LU_i^{-1} (rp_i - C_i x_{i+1}).
// Factors LU, Ms, C are (NX, 7, CS, nb) float32, rhs and x (NX, 7, nb), the
// lane axis last.
//
// Replaces: smc_tpu/ops/thomas_pallas.py, _stream_kernel (behind
// block_thomas_apply_pl, factors column-padded to 8) and _apply_kernel
// (behind block_thomas_apply_tiled, unpadded factors in 128-lane tiles).
// On the TPU these are two designs: one program over the whole batch with
// factor rows streamed through double-buffered VMEM by DMA and a
// whole-sweep rp scratch in VMEM, and a grid over lane tiles with the chain
// of a tile resident in VMEM. On the H100 both are the same kernel: one
// thread per lane walks the recurrence, the 7x7 algebra is unrolled over
// compile-time indices, and neighbouring threads read neighbouring
// addresses, so every access is coalesced without shared memory. The body
// is a template on the column stride CS; the two entry points below
// instantiate it for the padded (8) and the unpadded (7) factors. The pad
// column is never read.
//
// What bounds it on the H100: bytes. Three factor arrays of NX*49 floats
// per lane plus rhs and x (about 33 KB per lane at NX = 51) against about
// 120 FMAs per grid row.
//
// What the design does about it: each factor entry is read exactly once,
// straight into the FMA that spends it; the loads of a row do not depend on
// the recurrence, so they are issued ahead of it. rp (NX*7 floats per lane)
// does not fit in registers: it is written to the x output on the way
// forward and overwritten by x on the way back (row i's rp is read by the
// thread that then writes row i's x), so no scratch tensor is needed.
//
// Operation order follows _mv, _sub and _lu_solve of the TPU kernels
// (reciprocal, then multiply, for the pivots); nvcc contracts a*b + c into
// FMAs, so results differ from the plain PyTorch version in the last bits.
// A zero pivot gives inf/NaN in that lane only; nothing is guarded.
#include <cuda_runtime.h>

namespace {

constexpr int NF = 7;
constexpr int kThreads = 64;   // B = 15,360 lanes is 240 blocks on 132 SMs

template <int CS>
__global__ void __launch_bounds__(kThreads)
thomas_apply_kernel(const float* __restrict__ LU, const float* __restrict__ Ms,
                    const float* __restrict__ C, const float* __restrict__ rhs,
                    float* __restrict__ x, int nx, int nb) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= nb) return;
  const size_t snb = static_cast<size_t>(nb);
  const size_t frow = static_cast<size_t>(NF) * CS * snb;  // a factor row
  const size_t vrow = static_cast<size_t>(NF) * snb;       // a vector row
  auto at = [&](int r, int c) {
    return static_cast<size_t>(r * CS + c) * snb + lane;
  };
  auto vat = [&](int r) { return static_cast<size_t>(r) * snb + lane; };

  // Solve (L U) v = t in place from the combined factors at `lu`.
  auto lu_solve = [&](const float* lu, float (&v)[NF]) {
#pragma unroll
    for (int c = 0; c < NF; ++c)
#pragma unroll
      for (int r = c + 1; r < NF; ++r) v[r] = v[r] - lu[at(r, c)] * v[c];
#pragma unroll
    for (int c = NF - 1; c >= 0; --c) {
      float acc = v[c];
#pragma unroll
      for (int cc = c + 1; cc < NF; ++cc) acc = acc - lu[at(c, cc)] * v[cc];
      v[c] = acc * (1.0f / lu[at(c, c)]);
    }
  };

  // t = a - M v for the block at `blk` and the vector row at `a`.
  // `a` may be a row of x (rp on the way back), so it is a plain pointer.
  auto sub_mv = [&](const float* a, const float* blk, const float (&v)[NF],
                    float (&t)[NF]) {
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      float acc = blk[at(r, 0)] * v[0];
#pragma unroll
      for (int c = 1; c < NF; ++c) acc = acc + blk[at(r, c)] * v[c];
      t[r] = a[vat(r)] - acc;
    }
  };

  float v[NF], t[NF];
  // ---- forward: rp_i = r_i - m_i rp_{i-1}, kept in x ----------------------
#pragma unroll
  for (int r = 0; r < NF; ++r) {
    v[r] = rhs[vat(r)];
    x[vat(r)] = v[r];
  }
  for (int i = 1; i < nx; ++i) {
    sub_mv(rhs + i * vrow, Ms + i * frow, v, t);
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      v[r] = t[r];
      x[i * vrow + vat(r)] = t[r];
    }
  }
  // ---- backward: x_i = LU_i^{-1} (rp_i - C_i x_{i+1}) ---------------------
  lu_solve(LU + (nx - 1) * frow, v);
#pragma unroll
  for (int r = 0; r < NF; ++r) x[(nx - 1) * vrow + vat(r)] = v[r];
  for (int i = nx - 2; i >= 0; --i) {
    sub_mv(x + i * vrow, C + i * frow, v, t);
    lu_solve(LU + i * frow, t);
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      v[r] = t[r];
      x[i * vrow + vat(r)] = t[r];
    }
  }
}

template <int CS>
int launch(const float* LU, const float* Ms, const float* C, const float* rhs,
           float* x, int nx, int nb, void* stream) {
  if (nx < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (nb + kThreads - 1) / kThreads;
  thomas_apply_kernel<CS><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      LU, Ms, C, rhs, x, nx, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Column-padded factors (nx, 7, 8, nb), rhs (nx, 7, nb) -> x (nx, 7, nb).
// All float32, contiguous, on the device of `stream`.
extern "C" int thomas_apply_launch(const float* LU, const float* Ms,
                                   const float* C, const float* rhs, float* x,
                                   int nx, int nb, void* stream) {
  return launch<8>(LU, Ms, C, rhs, x, nx, nb, stream);
}

// The same solve on unpadded factors (nx, 7, 7, nb).
extern "C" int thomas_apply_tiled_launch(const float* LU, const float* Ms,
                                         const float* C, const float* rhs,
                                         float* x, int nx, int nb,
                                         void* stream) {
  return launch<7>(LU, Ms, C, rhs, x, nx, nb, stream);
}
