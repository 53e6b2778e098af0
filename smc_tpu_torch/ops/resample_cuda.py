"""Ancestor indices from sorted resampling offsets: CUDA kernel and plain
version.

Port of ``smc_tpu/ops/resample_pallas.py`` (``sorted_offsets_to_ancestors``):

    a[j] = max{ i : offsets[i] <= j },   j = 0..N-1

for the sorted int32 offsets of a resampling (all copies of particle i
occupy output slots [offsets[i], offsets[i+1])). Bitwise
equal to the scatter construction ``cumsum(hist(offsets)) - 1``, ties of
zero-count particles included. The kernel is ``csrc/merge.cu`` (a merge
path: each block resolves an equal piece of the offsets merged with the
slots); the JAX package launches its kernel only for N >= 4096 on a TPU,
this one at every N on CUDA. An ensemble's D offset ladders (D, N) go
through one launch. Every resampling scheme reaches it: residual-systematic
through its offsets, the others through ``counts_to_ancestors``
(smc/kernels.py).
"""
from __future__ import annotations

import torch

from smc_tpu_torch.ops import _build


def sorted_offsets_to_ancestors_plain(offsets: torch.Tensor) -> torch.Tensor:
    """The scatter construction: histogram of the offsets (offsets == N
    dropped), prefix sum, minus one, per row. (..., N) int32 in, int32
    out."""
    n = offsets.shape[-1]
    hist = torch.zeros(offsets.shape[:-1] + (n + 1,), dtype=torch.int32,
                       device=offsets.device)
    hist.scatter_add_(-1, offsets.long(), torch.ones_like(offsets))
    return (torch.cumsum(hist[..., :n], -1) - 1).to(torch.int32)


def sorted_offsets_to_ancestors(offsets: torch.Tensor) -> torch.Tensor:
    """offsets (N,) or (D, N) int32, each row sorted in [0, N] -> ancestors
    of the same shape, int32.

    CUDA tensors launch ``csrc/merge.cu`` (one launch for all D rows); CPU
    tensors take :func:`sorted_offsets_to_ancestors_plain`.
    """
    if offsets.device.type == "cpu":
        return sorted_offsets_to_ancestors_plain(offsets)
    if offsets.device.type != "cuda":
        raise ValueError(f"unsupported device {offsets.device}")
    if offsets.dim() not in (1, 2):
        raise ValueError(f"offsets must be (N,) or (D, N), got "
                         f"{tuple(offsets.shape)}")
    _build.check_input(offsets, "offsets", torch.int32, offsets.dim(),
                       offsets.device)
    b = offsets.shape[0] if offsets.dim() == 2 else 1
    n = offsets.shape[-1]
    if n >= 2 ** 30 or b > 65535:
        raise ValueError("N must be < 2^30 and D <= 65535")
    anc = torch.empty_like(offsets)
    err = _build.load().merge_launch(offsets.data_ptr(), anc.data_ptr(), b, n,
                                     _build.stream_ptr(offsets))
    _build.check(err, "merge")
    _build.launch_counts["merge"] += 1
    return anc
