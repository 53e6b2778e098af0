// Ancestor indices from sorted resampling offsets:
//   a[j] = max{ i : offsets[i] <= j },  j = 0..n-1,
// bitwise equal to cumsum(zeros.at[offsets].add(1)) - 1, including the ties
// that zero-count particles make (they repeat their successor's offset, and
// the max picks the surviving owner) and -1 for slots before offsets[0].
//
// Replaces: smc_tpu/ops/resample_pallas.py, _merge_kernel (the Pallas TPU
// kernel behind sorted_offsets_to_ancestors). The TPU kernel is a streaming
// two-pointer merge whose cursor lives in SMEM and carries across an
// "arbitrary" (sequential) grid. Nothing carries across blocks on Hopper,
// so here the same merge is cut into equal pieces that need no cursor.
//
// What bounds it on the H100: bytes, 4n read and 4n written (~0.24 us at
// n = 1e5 at 3.35 TB/s), far below the launch; the work is O(n) integer
// compares. What held the first kernel back was latency: a binary search
// per slot, ceil(log2(n + 1)) dependent loads (17 at n = 1e5).
//
// What the design does about it: a merge path, with few dependent round
// trips to memory. Merge the offsets with the slots 0..n-1, an offset i
// before slot j when offsets[i] <= j: offset i lands at position
// i + offsets[i], strictly increasing in i, and slot j after exactly
// a[j] + 1 offsets. Each block takes 2048 consecutive positions of that
// merged sequence:
// 1. two warps bracket where the block's first and last positions cut the
//    offsets (the count of i with i + offsets[i] below each) to 64
//    indices. The first round probes 128 points 32 apart around
//    position / 2, where a resampling's cut lies (its counts average 1),
//    so one round usually does; a miss goes on 128-ary (four probes a
//    lane a round). The first kernel took 17 dependent probes per slot at
//    n = 1e5, 20 at 1e6. A row of at most 2176 (the ensemble's and SBC's
//    rows of 2048) needs no bracket: it is staged whole;
// 2. the block's offsets with the two brackets (at most 2176) are staged
//    in shared memory with coalesced loads, and the exact cuts found there,
//    32-ary;
// 3. each thread cuts its own 8 positions out of the block's piece by a
//    binary search in shared memory, walks them (an offset advances the
//    owner, a slot takes it) and writes its slots' owners to shared memory;
// 4. the block stores its slots with coalesced stores.
// A block holds at most 2048 offsets and slots together whatever the
// counts are, so a zero-count run of any length (ties, which share one
// offset) spreads over as many blocks as it needs, blocks with no slot
// stop after step 2, and no path needs a window larger than shared memory.
//
// The population axis: an ensemble's B independent offset ladders (B, n)
// ride grid y, one launch for all; a block's work is the same whatever B
// is, so B = 1 gives the bits of the single-population launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                       // merged positions a thread
constexpr int kTile = kThreads * kItems;        // merged positions a block
constexpr int kProbes = 4;                      // a lane's probes a round
constexpr int kWays = 32 * kProbes;             // search arity
constexpr int kSlack = 64;                      // bracket width to stage at
constexpr int kGuessStep = 32;                  // first round's spacing
constexpr int kStage = kTile + 2 * kSlack;      // offsets staged a block

// One round of a warp's search for the cut of `pos` (the number of i with
// i + offsets[i] < pos): probes at lo + m * step, m < kWays, below hi.
// Returns how many probes lie below pos; i + offsets[i] is strictly
// increasing, so they are the first ones.
__device__ __forceinline__ int probe_round(const int* __restrict__ offsets,
                                           int lo, int hi, int step, int pos) {
  const int lane = threadIdx.x & 31;
  int below = 0;
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    const int i = lo + (p * 32 + lane) * step;
    below += (i < hi && i + __ldg(offsets + i) < pos) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    below += __shfl_xor_sync(0xffffffffu, below, off);
  return below;
}

// A bracket [lo, hi], at most kSlack wide, that holds the cut of `pos`,
// found by one warp. The cut lies in [max(0, pos - n), min(pos, n)]. The
// first round probes kWays points kGuessStep apart around pos / 2: the
// counts of a resampling average 1, so offsets[i] stays near i and the cut
// near pos / 2 (within ~sqrt(pos) for random counts); when it misses, the
// bracket it leaves is searched kWays-ary.
__device__ __forceinline__ int2 warp_bracket(const int* __restrict__ offsets,
                                             int n, int pos) {
  int lo = max(0, pos - n), hi = min(pos, n);
  if (hi - lo > kSlack) {
    const int span = kWays * kGuessStep;
    const int start = max(lo, min(pos / 2 - span / 2, hi - span));
    const int below = probe_round(offsets, start, hi, kGuessStep, pos);
    if (below == 0) {
      hi = start;
    } else {
      lo = start + (below - 1) * kGuessStep + 1;
      if (below < kWays) hi = min(hi, start + below * kGuessStep);
    }
  }
  while (hi - lo > kSlack) {
    const int step = (hi - lo + kWays - 1) / kWays;
    const int below = probe_round(offsets, lo, hi, step, pos);
    if (below == 0) {
      hi = lo;
    } else {
      const int last = lo + (below - 1) * step;   // below pos
      hi = min(hi, last + step);
      lo = last + 1;
    }
  }
  return make_int2(lo, hi);
}

// grid (ceil(2n / kTile), b), kThreads threads.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int* __restrict__ offsets, int* __restrict__ anc, int n) {
  __shared__ int sh_off[kStage];
  __shared__ int sh_anc[kTile];
  __shared__ int2 bracket[2];
  __shared__ int cut[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  offsets += static_cast<size_t>(blockIdx.y) * n;
  anc += static_cast<size_t>(blockIdx.y) * n;
  const int d0 = blockIdx.x * kTile;
  const int d1 = min(d0 + kTile, 2 * n);
  if (warp < 2) {
    // A row that fits the stage is staged whole, with no search in global
    // memory (the ensemble's and SBC's rows of 2048).
    const int pos = warp == 0 ? d0 : d1;
    const int2 b = n <= kStage ? make_int2(0, n)
                               : warp_bracket(offsets, n, pos);
    if (lane == 0) bracket[warp] = b;
  }
  __syncthreads();
  // The block's offsets lie between the two cuts, cut0 <= cut1, and the
  // brackets add at most kSlack on either side: stage them all at once.
  const int s0 = bracket[0].x;
  const int hi1 = min(bracket[1].y, s0 + kStage);
  const int lo1 = max(bracket[1].x, s0);
  const int hi0 = min(bracket[0].y, hi1);
  for (int q = t; q < hi1 - s0; q += kThreads)
    sh_off[q] = __ldg(offsets + s0 + q);
  __syncthreads();
  if (warp < 2) {             // the exact cuts, 32-ary in the staged offsets
    const int pos = warp == 0 ? d0 : d1;
    int lo = max(warp == 0 ? s0 : lo1, pos - n);
    int hi = min(warp == 0 ? hi0 : hi1, pos);
    while (lo < hi) {
      const int step = (hi - lo + 31) / 32;
      const int i = lo + lane * step;
      const unsigned below = __ballot_sync(
          0xffffffffu, i < hi && i + sh_off[i - s0] < pos);
      const int c = __popc(below);              // a prefix of the lanes
      if (c == 0) {
        hi = lo;
      } else {
        const int last = lo + (c - 1) * step;
        hi = min(hi, last + step);
        lo = last + 1;
      }
    }
    if (lane == 0) cut[warp] = lo;
  }
  __syncthreads();
  const int i0 = cut[0], i1 = cut[1];
  const int j0 = d0 - i0;
  const int ka = min(max(i1 - i0, 0), kTile);         // the block's offsets
  const int kb = min(max(d1 - i1 - j0, 0), kTile);    // the block's slots
  if (kb == 0) return;
  const int* so = sh_off + (i0 - s0);

  // This thread's positions [p0, p0 + kItems) of the block's piece: cut the
  // block's offsets at p0 (a[j] counts those with i + offsets[i] below it).
  const int p0 = t * kItems;
  const int len = ka + kb;
  if (p0 < len) {
    const int target = d0 + p0 - i0;          // key - i0 below this
    int lo = max(0, p0 - kb), hi = min(p0, ka);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mid + so[mid] < target)
        lo = mid + 1;
      else
        hi = mid;
    }
    int pi = lo, pj = p0 - lo;                // offsets taken, slots taken
    const int end = min(p0 + kItems, len);
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      if (p0 + s < end) {
        const bool take = pi < ka && (pj >= kb || so[pi] <= j0 + pj);
        if (take) {
          ++pi;
        } else {
          sh_anc[pj] = i0 + pi - 1;
          ++pj;
        }
      }
    }
  }
  __syncthreads();
  for (int q = t; q < kb; q += kThreads) anc[j0 + q] = sh_anc[q];
}

}  // namespace

// The grid's extent along the merged sequence for n slots.
extern "C" int merge_blocks(int n) {
  return static_cast<int>((2LL * n + kTile - 1) / kTile);
}

// offsets (b, n) int32, each row sorted in [0, n] -> ancestors (b, n) int32;
// contiguous, on the device of `stream`; b <= 65535, n < 2^30.
extern "C" int merge_launch(const int* offsets, int* anc, int b, int n,
                            void* stream) {
  if (n == 0 || b == 0) return 0;
  const dim3 grid(merge_blocks(n), b);
  merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, anc, n);
  return static_cast<int>(cudaGetLastError());
}
