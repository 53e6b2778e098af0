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
// of a tile resident in VMEM. On the H100 both are one kernel, a template
// on the column stride CS; the two entry points below instantiate it for
// the padded (8) and the unpadded (7) factors. The pad column is never read.
//
// What bounds it on the H100: bytes. Three factor arrays of NX*49 floats
// per lane plus rhs and x (about 33 KB per lane at NX = 51) against about
// 170 fp32 instructions per grid row. The lanes are independent but each
// walks a serial chain of 2 NX rows, so the card holds few threads: the
// march's B = 15,360 lanes are 480 warps, under four per SM. At that
// occupancy the device memory is kept busy only if each warp has several
// rows' bytes in flight while it computes.
//
// What the design does about it: a block owns a tile of kLanes lanes, one
// thread per lane, and stages the rows of its sweep through a ring of
// kStages stages in shared memory (ring.cuh). Each thread copies its own
// lane's entries of a row with cp.async, kStages - 1 rows ahead of its
// arithmetic, and reads them back from its own bank. A stage holds rhs_i
// and Ms_i on the way forward, LU_i and C_i on the way back; the backward
// rows are issued during the last forward rows, so the ring never drains
// between the sweeps. The copies pass through L1, so the SM keeps kCarveout
// percent of its L1 and shared memory as shared memory and the rest as L1
// (196 KB and 60 KB): at the default split, 228 KB of shared memory, 28 KB
// of L1 held the bytes in flight below what the device memory needs.
// rp (NX*7 floats per lane) stays in shared memory behind the ring where
// two tiles of it fit in an SM (NX <= kRpSharedRows), so x is written once;
// at larger NX it goes to x on the way forward and is read back a row ahead
// of its use on the way back, where the thread overwrites it with x. At
// B = 15,360 on an H100 rp in shared memory is 10% faster up to NX = 68
// (two tiles per SM) and 1.45-1.47x slower from NX = 80 on (one tile per SM
// against five with rp in x).
//
// Operation order follows _mv, _sub and _lu_solve of the TPU kernels
// (reciprocal, then multiply, for the pivots); nvcc contracts a*b + c into
// FMAs, so results differ from the plain PyTorch version in the last bits.
// A zero pivot gives inf/NaN in that lane only; nothing is guarded.
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int NF = 7;
constexpr int NB = NF * NF;
constexpr int kLanes = 32;     // lanes (threads) per block
constexpr int kStages = 3;     // rows in the ring
constexpr int kCarveout = 85;  // percent of L1 + shared kept as shared
constexpr int kSlot = 2 * NB;  // floats per lane and stage: LU_i and C_i
constexpr int kRpSharedRows = 68;   // up to here rp stays in shared memory

// Dynamic shared memory of a launch: the ring, and rp where it is kept.
constexpr size_t smem_bytes(int nx, bool rp_shared) {
  return sizeof(float) * kLanes *
         (kStages * kSlot + (rp_shared ? static_cast<size_t>(nx) * NF : 0));
}
// Two tiles, each with its block's 1 KB reserve, fit in the 196 KB that
// the carve-out keeps as shared memory.
static_assert(2 * (smem_bytes(kRpSharedRows, true) + 1024) <= 196 * 1024,
              "rp of kRpSharedRows rows leaves room for two tiles per SM");

bool smem_set[2][2][64];       // per column stride, rp placement and device

// Copy step k of this lane into stage `st`: forward row k < nx as rhs_k
// (entries 0-6) and Ms_k (7-55, none for k = 0); backward row
// i = 2 nx - 1 - k as LU_i (0-48) and C_i (49-97, none for the last row).
template <int CS>
__device__ __forceinline__ void issue(float* st, int k, int nx, size_t snb,
                                      const float* LU, const float* Ms,
                                      const float* C, const float* rhs) {
  const size_t frow = static_cast<size_t>(NF) * CS * snb;
  if (k < nx) {
    const float* rk = rhs + k * NF * snb;
#pragma unroll
    for (int e = 0; e < NF; ++e) ring::copy4(st + e * kLanes, rk + e * snb);
    if (k > 0) {
      const float* m = Ms + k * frow;
#pragma unroll
      for (int r = 0; r < NF; ++r)
#pragma unroll
        for (int c = 0; c < NF; ++c)
          ring::copy4(st + (NF + r * NF + c) * kLanes, m + (r * CS + c) * snb);
    }
  } else if (k < 2 * nx) {
    const int i = 2 * nx - 1 - k;
    const float* lu = LU + i * frow;
    const float* cc = C + i * frow;
#pragma unroll
    for (int r = 0; r < NF; ++r)
#pragma unroll
      for (int c = 0; c < NF; ++c)
        ring::copy4(st + (r * NF + c) * kLanes, lu + (r * CS + c) * snb);
    if (i < nx - 1) {
#pragma unroll
      for (int r = 0; r < NF; ++r)
#pragma unroll
        for (int c = 0; c < NF; ++c)
          ring::copy4(st + (NB + r * NF + c) * kLanes,
                      cc + (r * CS + c) * snb);
    }
  }
  ring::commit();
}

template <int CS, bool RpShared>
__global__ void __launch_bounds__(kLanes)
thomas_apply_kernel(const float* __restrict__ LU, const float* __restrict__ Ms,
                    const float* __restrict__ C, const float* __restrict__ rhs,
                    float* __restrict__ x, int nx, int nb) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= nb) return;
  const size_t snb = static_cast<size_t>(nb);
  const size_t vrow = static_cast<size_t>(NF) * snb;  // a vector row
  // The lane's own column: entry e of stage s is base[(s * kSlot + e) *
  // kLanes]; the global arrays are offset to the lane once, here.
  float* base = smem + threadIdx.x;
  float* rps = base + kStages * kSlot * kLanes;   // rp_i[r] at (i*NF+r)*kLanes
  LU += lane, Ms += lane, C += lane, rhs += lane, x += lane;

  int wr = 0;
  for (int k = 0; k < kStages - 1; ++k, ++wr)
    issue<CS>(base + wr * kSlot * kLanes, k, nx, snb, LU, Ms, C, rhs);

  float v[NF], rp[NF];
  int rd = 0;
#pragma unroll 1
  for (int k = 0; k < 2 * nx; ++k) {
    issue<CS>(base + wr * kSlot * kLanes, k + kStages - 1, nx, snb, LU, Ms,
              C, rhs);
    wr = wr + 1 == kStages ? 0 : wr + 1;
    ring::wait<kStages - 1>();                 // step k has landed
    const float* s = base + rd * kSlot * kLanes;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    auto at = [&](int e) { return s[e * kLanes]; };

    if (k < nx) {
      // ---- forward: rp_k = r_k - m_k rp_{k-1} ----------------------------
      if (k == 0) {
#pragma unroll
        for (int r = 0; r < NF; ++r) v[r] = at(r);
      } else {
        float t[NF];
#pragma unroll
        for (int r = 0; r < NF; ++r) {
          float acc = at(NF + r * NF) * v[0];
#pragma unroll
          for (int c = 1; c < NF; ++c) acc = acc + at(NF + r * NF + c) * v[c];
          t[r] = at(r) - acc;
        }
#pragma unroll
        for (int r = 0; r < NF; ++r) v[r] = t[r];
      }
      if (k < nx - 1) {                        // the last rp stays in v
#pragma unroll
        for (int r = 0; r < NF; ++r) {
          if (RpShared)
            rps[(k * NF + r) * kLanes] = v[r];
          else
            x[k * vrow + r * snb] = v[r];
        }
      }
    } else {
      // ---- backward: x_i = LU_i^{-1} (rp_i - C_i x_{i+1}) -----------------
      const int i = 2 * nx - 1 - k;
      if (i < nx - 1) {
        float t[NF];
#pragma unroll
        for (int r = 0; r < NF; ++r) {
          float acc = at(NB + r * NF) * v[0];
#pragma unroll
          for (int c = 1; c < NF; ++c) acc = acc + at(NB + r * NF + c) * v[c];
          t[r] = (RpShared ? rps[(i * NF + r) * kLanes] : rp[r]) - acc;
        }
#pragma unroll
        for (int r = 0; r < NF; ++r) v[r] = t[r];
      }
      // Solve (L U) v = t in place from the combined factors LU_i.
#pragma unroll
      for (int c = 0; c < NF; ++c)
#pragma unroll
        for (int r = c + 1; r < NF; ++r) v[r] = v[r] - at(r * NF + c) * v[c];
#pragma unroll
      for (int c = NF - 1; c >= 0; --c) {
        float acc = v[c];
#pragma unroll
        for (int cc = c + 1; cc < NF; ++cc) acc = acc - at(c * NF + cc) * v[cc];
        v[c] = acc * (1.0f / at(c * NF + c));
      }
#pragma unroll
      for (int r = 0; r < NF; ++r) x[i * vrow + r * snb] = v[r];
      if (!RpShared && i > 0) {                // rp_{i-1}, a row ahead
#pragma unroll
        for (int r = 0; r < NF; ++r) rp[r] = x[(i - 1) * vrow + r * snb];
      }
    }
  }
  ring::wait<0>();
}

template <int CS, bool RpShared>
cudaError_t launch_rp(const float* LU, const float* Ms, const float* C,
                      const float* rhs, float* x, int nx, int nb,
                      cudaStream_t stream) {
  const cudaError_t err = ring::allow_smem(thomas_apply_kernel<CS, RpShared>,
                                           kCarveout,
                                           smem_set[CS - NF][RpShared]);
  if (err != cudaSuccess) return err;
  const int blocks = (nb + kLanes - 1) / kLanes;
  thomas_apply_kernel<CS, RpShared>
      <<<blocks, kLanes, smem_bytes(nx, RpShared), stream>>>(LU, Ms, C, rhs,
                                                             x, nx, nb);
  return cudaGetLastError();
}

template <int CS>
int launch(const float* LU, const float* Ms, const float* C, const float* rhs,
           float* x, int nx, int nb, void* stream) {
  if (nx < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      nx <= kRpSharedRows ? launch_rp<CS, true>(LU, Ms, C, rhs, x, nx, nb, s)
                          : launch_rp<CS, false>(LU, Ms, C, rhs, x, nx, nb, s));
}

template <int CS>
int info(int nx, int* out) {
  const bool rp = nx <= kRpSharedRows;
  return static_cast<int>(
      rp ? ring::info(thomas_apply_kernel<CS, true>, kLanes,
                      smem_bytes(nx, true), kCarveout, smem_set[CS - NF][1],
                      out)
         : ring::info(thomas_apply_kernel<CS, false>, kLanes,
                      smem_bytes(nx, false), kCarveout, smem_set[CS - NF][0],
                      out));
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

// Registers, shared bytes per block, resident blocks per SM and spilled
// bytes of the kernel that a launch at `nx` grid rows and column stride
// `cs` (7 or 8) runs, into out[0..3]; lanes per block into out[4].
extern "C" int thomas_apply_info(int cs, int nx, int* out) {
  if ((cs != 7 && cs != 8) || nx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  out[4] = kLanes;
  return cs == 7 ? info<7>(nx, out) : info<8>(nx, out);
}
