// Gamma-ladder weight sums: for K candidate tempering increments dg_k,
//   s1[k] = sum_i exp(d_i * dg_k),   s2[k] = sum_i exp(d_i * dg_k)^2.
//
// Replaces: smc_tpu/ops/ladder_pallas.py, _ladder_kernel (the Pallas TPU
// kernel behind ladder_stats). On the TPU the grid runs in order and the
// kernel carries (K, tile) accumulators in VMEM from one grid step to the
// next. Hopper blocks run in parallel and carry nothing across, so each
// block sums its chunks of particles for one group of candidates, and the
// last block of a (population, group) to finish adds every block's partial
// in block order, in the same launch.
//
// What bounds it on the H100: operations. N*K IEEE expf, each with one
// multiply before it and an add and a multiply-add after it, against 4*N
// bytes of input: at K = 81 that is ~100 fp32 instructions per byte, far
// above the card's ~10 per byte of HBM. At the main path's N = 1e5 the
// whole pass is ~2 us at the fp32 pipes' rate, so the launch, the tail of
// the grid and the cross-block sum decide how close it gets.
//
// What the design does about it:
// - One launch. A block writes its 16 sums to scratch and takes a ticket
//   from its (population, group) counter with one acquire-release atomic;
//   the block that draws the last ticket adds the partials of all blocks
//   in block order (eight strided runs, then a fixed tree) and sets the
//   counter back to 0, ready for the next call and for every replay of a
//   captured graph. The counters are kept zero by the kernel itself: the
//   wrapper allocates them zeroed once and never again. No fp32 atomics,
//   so the sums, and the ESS decision find_gamma takes from them, are the
//   same bits on every run.
// - Each thread loads its eight particles once (two 16-byte loads where
//   the row is 16-byte aligned), keeps them in registers and evaluates its
//   block's group of up to eight candidates on them: 64 independent expf
//   per thread, 16 accumulators. A warp reduces its 16 sums with a
//   transposing shuffle tree (each step halves the values a lane holds:
//   16 shuffles in all, not 16 x 5), then four warps add through shared
//   memory.
// - No bounds tests in the steady loop: only the last chunk of a row is
//   ragged and takes the masked variant. A row that is not 16-byte aligned
//   (an ensemble's rows when N is not a multiple of 4) takes scalar loads
//   of the same particles, not a peeled head: which thread sums which
//   particle, and so every bit of the result, depends on N alone, never on
//   where the row lies. So a population's row has the same bits in a
//   batched call as alone, and a block's arithmetic never depends on B.
// - 32-bit index arithmetic (the wrapper refuses N >= 2^31); IEEE expf (no
//   fast math: find_gamma's choice rests on these sums).
// - Chunks of 1024 particles and groups of 8 candidates, 128 threads a
//   block. A row of more than 96 chunks gives each block several, in
//   order, so that the grid stays one wave of blocks that each work long
//   (N = 1e5, K = 81: 539 blocks of 2 chunks; N = 1e6: 979 of 11) and the
//   last block adds at most 96 partials, 12 loads a lane, all in flight
//   before the first add. A shorter row takes the kernel's instance
//   without the loop, which holds fewer registers and so more blocks on
//   an SM (an ensemble's rows of 2048: 2 chunks, 1,408 blocks at D = 64).
//
// -inf entries of d contribute exp(-inf * dg) = 0 because dg > 0; the
// ragged tail contributes exact zeros.
//
// The population axis: an ensemble holds B independent populations, each
// with its own d (B, N) and its own increments dg (B, K). They ride grid z,
// so one launch serves them all. (The TPU kernel has no such axis: its
// scalar-memory operand cannot be tiled, so the reference sends a vmapped
// ladder to its plain form.)
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;              // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // particles per thread
constexpr int kChunk = kThreads * kPer;    // particles per block
constexpr int kGroup = 8;                  // candidates per block (grid y)
constexpr int kVals = 2 * kGroup;          // sums per block: s1[8], s2[8]
constexpr int kLanes = kThreads / kVals;   // final-sum lanes per value
constexpr int kMaxBlocks = 96;             // grid x cap (chunks_per_block)
static_assert(kWarps == 4 && kLanes == 8, "the fixed sums below");

__host__ __device__ inline int chunk_count(int n) {
  return n <= kChunk ? 1 : (n - 1) / kChunk + 1;
}

// Particle q of thread t in a chunk: 4t + (q mod 4) in the (q / 4)-th run
// of 4 * kThreads particles, so that each of a warp's 16-byte loads covers
// 512 contiguous bytes.
__device__ __forceinline__ int slot(int t, int q) {
  return (q >> 2) * (4 * kThreads) + 4 * t + (q & 3);
}

// The thread's eight particles of the chunk at `base`; kRagged masks those
// at or beyond n (they load as 0 and the caller drops their terms).
template <bool kRagged>
__device__ __forceinline__ void load(const float* __restrict__ row, int base,
                                     int n, bool aligned, float (&x)[kPer]) {
  const int t = threadIdx.x;
  if (!kRagged && aligned) {
#pragma unroll
    for (int h = 0; h < kPer / 4; ++h) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          row + base + h * (4 * kThreads) + 4 * t));
      x[4 * h] = v.x;
      x[4 * h + 1] = v.y;
      x[4 * h + 2] = v.z;
      x[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = base + slot(t, q);
      x[q] = (!kRagged || i < n) ? __ldg(row + i) : 0.0f;
    }
  }
}

// acc[c] += w and acc[kGroup + c] += w * w over the thread's particles, for
// the G candidates g[0..G); acc[c], acc[kGroup + c] stay 0 for c >= G.
template <int G, bool kRagged>
__device__ __forceinline__ void accumulate(const float (&x)[kPer],
                                           const float (&g)[kGroup], int base,
                                           int n, float (&acc)[kVals]) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const bool valid = !kRagged || base + slot(threadIdx.x, q) < n;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      float w = expf(x[q] * g[c]);
      if (kRagged) w = valid ? w : 0.0f;
      acc[c] += w;
      acc[kGroup + c] = fmaf(w, w, acc[kGroup + c]);
    }
  }
}

// The block's chunks [c0, c1) of the row, in order, into the same
// accumulators; only a chunk that reaches past n takes the masked variant.
template <int G>
__device__ __forceinline__ void sum_chunks(const float* __restrict__ row,
                                           int c0, int c1, int n, bool aligned,
                                           const float (&g)[kGroup],
                                           float (&acc)[kVals]) {
  for (int c = c0; c < c1; ++c) {
    const int base = c * kChunk;
    float x[kPer];
    if (base + kChunk <= n) {
      load<false>(row, base, n, aligned, x);
      accumulate<G, false>(x, g, base, n, acc);
    } else {
      load<true>(row, base, n, aligned, x);
      accumulate<G, true>(x, g, base, n, acc);
    }
  }
}

__device__ __forceinline__ void sum_chunks_of(int kc, const float* row,
                                              int c0, int c1, int n,
                                              bool aligned,
                                              const float (&g)[kGroup],
                                              float (&acc)[kVals]) {
  switch (kc) {
    case 8: sum_chunks<8>(row, c0, c1, n, aligned, g, acc); break;
    case 7: sum_chunks<7>(row, c0, c1, n, aligned, g, acc); break;
    case 6: sum_chunks<6>(row, c0, c1, n, aligned, g, acc); break;
    case 5: sum_chunks<5>(row, c0, c1, n, aligned, g, acc); break;
    case 4: sum_chunks<4>(row, c0, c1, n, aligned, g, acc); break;
    case 3: sum_chunks<3>(row, c0, c1, n, aligned, g, acc); break;
    case 2: sum_chunks<2>(row, c0, c1, n, aligned, g, acc); break;
    default: sum_chunks<1>(row, c0, c1, n, aligned, g, acc); break;
  }
}

// One transposing step over the first M values: a lane whose bit `M` is
// set keeps the upper half and sends the lower half to its partner
// (lane ^ M), which does the opposite; each adds what it receives.
template <int M>
__device__ __forceinline__ void transpose_step(float (&v)[kVals]) {
  const bool upper = (threadIdx.x & M) != 0;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float send = upper ? v[i] : v[i + M / 2];
    const float keep = upper ? v[i + M / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Sums each of the 16 values over the warp's 32 lanes: four transposing
// steps, then one plain step. Returns value lane >> 1 (lanes 2v and 2v + 1
// hold the same bits of value v).
__device__ __forceinline__ float warp_sum16(float (&v)[kVals]) {
  static_assert(kVals == 16, "the steps below halve 16 values to 1");
  transpose_step<16>(v);
  transpose_step<8>(v);
  transpose_step<4>(v);
  transpose_step<2>(v);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// grid (blocks, groups, b), kThreads threads; block x sums chunks
// [x * per_block, (x + 1) * per_block) of its row (kLoop), or chunk x
// (per_block is 1: the instance without the loop keeps fewer registers and
// so more blocks on an SM). partial: (b, groups, blocks, kVals) scratch;
// tickets: (b, groups) int32, zero on entry, zero on exit.
template <bool kLoop>
__global__ void __launch_bounds__(kThreads)
ladder_kernel(const float* __restrict__ d, const float* __restrict__ dg,
              float* __restrict__ partial, unsigned* __restrict__ tickets,
              float* __restrict__ s1, float* __restrict__ s2, int n, int k,
              int per_block) {
  __shared__ float sh[kWarps][kVals];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int blk = blockIdx.x, blocks = gridDim.x;
  const int group = blockIdx.y, groups = gridDim.y;
  const int pop = blockIdx.z;
  const int k0 = group * kGroup;
  const int kc = min(kGroup, k - k0);
  const float* row = d + static_cast<size_t>(pop) * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;

  float g[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c)
    g[c] = c < kc ? __ldg(dg + static_cast<size_t>(pop) * k + k0 + c) : 0.0f;

  float acc[kVals];
#pragma unroll
  for (int v = 0; v < kVals; ++v) acc[v] = 0.0f;
  const int c0 = kLoop ? blk * per_block : blk;
  const int c1 = kLoop ? min(chunk_count(n), c0 + per_block) : c0 + 1;
  sum_chunks_of(kc, row, c0, c1, n, aligned, g, acc);

  const float wsum = warp_sum16(acc);
  if ((lane & 1) == 0) sh[warp][lane >> 1] = wsum;
  __syncthreads();
  const size_t slot0 = static_cast<size_t>(pop) * groups + group;
  float* part = partial + slot0 * blocks * kVals;
  if (t < kVals)
    part[blk * kVals + t] = ((sh[0][t] + sh[1][t]) + sh[2][t]) + sh[3][t];
  __syncthreads();
  if (t == 0) {
    // Release the block's partial (the barrier orders the other threads'
    // stores before it) and acquire every earlier block's, in one atomic.
    unsigned ticket;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(ticket) : "l"(tickets + slot0) : "memory");
    last = ticket == blocks - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block of this (population, group): every partial is written.
  // A lane's (at most kMaxBlocks / kLanes) loads all go out first.
  const int v = t % kVals, lane8 = t / kVals;
  float pv[kMaxBlocks / kLanes];
#pragma unroll
  for (int i = 0; i < kMaxBlocks / kLanes; ++i) {
    const int c = lane8 + i * kLanes;
    pv[i] = c < blocks ? __ldcg(part + c * kVals + v) : 0.0f;
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxBlocks / kLanes; ++i) s += pv[i];
  s += __shfl_xor_sync(0xffffffffu, s, 16);   // lanes 2w and 2w + 1
  if (lane < kVals) sh[warp][lane] = s;
  __syncthreads();
  if (t < kVals) {
    const float total = (sh[0][t] + sh[1][t]) + (sh[2][t] + sh[3][t]);
    const int c = t % kGroup;
    if (c < kc) {
      float* out = t < kGroup ? s1 : s2;
      out[static_cast<size_t>(pop) * k + k0 + c] = total;
    }
  }
  if (t == 0) tickets[slot0] = 0u;
}

// Chunks a block sums: one while a row has at most kMaxBlocks chunks, so
// that a short row spreads over as many blocks as it can; beyond, as few as
// keep the grid at kMaxBlocks blocks a (population, group), so that a long
// row is one wave of blocks that each work long, not many short ones (at
// n = 1e5: 2 chunks, 49 blocks; at 1e6: 11 chunks, 89 blocks). It depends
// on n alone.
int chunks_per_block(int n) {
  return (chunk_count(n) + kMaxBlocks - 1) / kMaxBlocks;
}

}  // namespace

// The grid's particle-block and candidate-group extents: the caller sizes
// ladder_launch's scratch from them, partial (b, groups, blocks, 16)
// float32 and tickets (b, groups) int32.
extern "C" int ladder_blocks(int n) {
  const int per = chunks_per_block(n);
  return (chunk_count(n) + per - 1) / per;
}

extern "C" int ladder_groups(int k) { return (k + kGroup - 1) / kGroup; }

// d_ll (b, n), dg (b, k) -> s1, s2 (b, k), one launch. All float32,
// contiguous, on the device of `stream`; tickets zero (the kernel leaves
// them zero); b <= 65535, k <= 65535 * 8.
extern "C" int ladder_launch(const float* d_ll, const float* dg, float* partial,
                             unsigned* tickets, float* s1, float* s2, int b,
                             int n, int k, void* stream) {
  if (k == 0 || b == 0) return 0;
  const dim3 grid(ladder_blocks(n), ladder_groups(k), b);
  const int per = chunks_per_block(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per > 1)
    ladder_kernel<true><<<grid, kThreads, 0, s>>>(d_ll, dg, partial, tickets,
                                                  s1, s2, n, k, per);
  else
    ladder_kernel<false><<<grid, kThreads, 0, s>>>(d_ll, dg, partial, tickets,
                                                   s1, s2, n, k, per);
  return static_cast<int>(cudaGetLastError());
}
