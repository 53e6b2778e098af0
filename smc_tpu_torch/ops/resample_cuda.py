"""Ancestor indices from sorted resampling offsets: CUDA kernel and plain
version.

Port of ``smc_tpu/ops/resample_pallas.py`` (``sorted_offsets_to_ancestors``):

    a[j] = max{ i : offsets[i] <= j },   j = 0..N-1

for the sorted int32 offsets of residual-systematic resampling (all copies
of particle i occupy output slots [offsets[i], offsets[i+1])). Bitwise
equal to the scatter construction ``cumsum(hist(offsets)) - 1``, ties of
zero-count particles included. The kernel is ``csrc/merge.cu``; the JAX
package launches its kernel only for N >= 4096 on a TPU, this one at every
N on CUDA.
"""
from __future__ import annotations

import torch

from smc_tpu_torch.ops import _build


def sorted_offsets_to_ancestors_plain(offsets: torch.Tensor) -> torch.Tensor:
    """The scatter construction: histogram of the offsets (offsets == N
    dropped), prefix sum, minus one. int32 in, int32 out."""
    n = offsets.shape[0]
    hist = torch.zeros(n + 1, dtype=torch.int32, device=offsets.device)
    hist.index_add_(0, offsets.long(), torch.ones_like(offsets))
    return (torch.cumsum(hist[:n], 0) - 1).to(torch.int32)


def sorted_offsets_to_ancestors(offsets: torch.Tensor) -> torch.Tensor:
    """offsets (N,) int32 sorted in [0, N] -> ancestors (N,) int32.

    CUDA tensors launch ``csrc/merge.cu``; CPU tensors take
    :func:`sorted_offsets_to_ancestors_plain`.
    """
    if offsets.device.type == "cpu":
        return sorted_offsets_to_ancestors_plain(offsets)
    if offsets.device.type != "cuda":
        raise ValueError(f"unsupported device {offsets.device}")
    _build.check_input(offsets, "offsets", torch.int32, 1, offsets.device)
    n = offsets.shape[0]
    if n >= 2 ** 30:
        raise ValueError("N must be < 2^30")
    anc = torch.empty(n, dtype=torch.int32, device=offsets.device)
    err = _build.load().merge_launch(offsets.data_ptr(), anc.data_ptr(), n,
                                     _build.stream_ptr(offsets))
    _build.check(err, "merge")
    _build.launch_counts["merge"] += 1
    return anc
