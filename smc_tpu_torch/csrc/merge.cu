// Ancestor indices from sorted resampling offsets:
//   a[j] = max{ i : offsets[i] <= j },  j = 0..n-1,
// bitwise equal to cumsum(zeros.at[offsets].add(1)) - 1, including the ties
// that zero-count particles make (they repeat their successor's offset, and
// the max picks the surviving owner) and -1 for slots before offsets[0].
//
// Replaces: smc_tpu/ops/resample_pallas.py, _merge_kernel (the Pallas TPU
// kernel behind sorted_offsets_to_ancestors). The TPU kernel is a streaming
// two-pointer merge whose cursor lives in SMEM and carries across an
// "arbitrary" (sequential) grid. Nothing carries across blocks on Hopper, so
// each output slot here finds its owner by itself: a binary search for the
// first offset above j. Every slot costs the same ceil(log2(n + 1)) probes
// whatever the counts are, so a particle that takes all n slots costs no
// more than n particles with one slot each.
//
// What bounds it on the H100: bytes, 4n read and 4n written, ~0.24 us at
// n = 1e5 at 3.35 TB/s; the probes hit the offsets in L1/L2 (400 KB at
// n = 1e5, well inside the 50 MB L2), and the first probes of all threads
// of a block touch the same few lines.
//
// The population axis: an ensemble's B independent offset ladders (B, n) ride
// grid y, one launch for all; a slot's search is the same whatever B is, so
// B = 1 gives the bits of the single-population launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int* __restrict__ offsets, int* __restrict__ anc, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  offsets += static_cast<size_t>(blockIdx.y) * n;
  anc += static_cast<size_t>(blockIdx.y) * n;
  unsigned lo = 0, hi = static_cast<unsigned>(n);
  while (lo < hi) {  // first i with offsets[i] > j
    const unsigned mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  anc[j] = static_cast<int>(lo) - 1;
}

}  // namespace

// offsets (b, n) int32, each row sorted in [0, n] -> ancestors (b, n) int32;
// contiguous, on the device of `stream`; b <= 65535.
extern "C" int merge_launch(const int* offsets, int* anc, int b, int n,
                            void* stream) {
  if (n == 0 || b == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, anc, n);
  return static_cast<int>(cudaGetLastError());
}
