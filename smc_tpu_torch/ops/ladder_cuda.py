"""Gamma-ladder weight sums: CUDA kernel and plain version.

Port of ``smc_tpu/ops/ladder_pallas.py`` (``ladder_stats``): for K candidate
increments dg_k,

    s1[k] = sum_i exp(d_ll[i] * dg[k]),   s2[k] = sum_i exp(d_ll[i] * dg[k])^2

in one pass over the particles. ``find_gamma`` forms the normalized ESS
s1^2 / (s2 N) of every candidate from them. -inf entries contribute 0 while
dg > 0. The kernel is ``csrc/ladder.cu``: per-block partial sums plus a
second pass in a fixed order (no atomics), so the result is the same on
every run.

An ensemble's populations ride a leading axis: d_ll (D, N) with each
population's own increments dg (D, K) gives (D, K) sums from one launch. The
JAX package sends the vmapped ladder to its plain form; here the kernel
takes the axis.
"""
from __future__ import annotations

from typing import Tuple

import torch

from smc_tpu_torch.ops import _build

_MAX_K = 4096        # candidates (grid y = K / 8)
_MAX_B = 65535       # populations (grid z)


def ladder_stats_plain(d_ll: torch.Tensor, dg: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N) x (..., K) -> (s1, s2), each (..., K): one (..., K, N) exp
    and two row sums."""
    w = torch.exp(d_ll[..., None, :] * dg[..., :, None])
    return torch.sum(w, dim=-1), torch.sum(w * w, dim=-1)


def ladder_stats(d_ll: torch.Tensor, dg: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """d_ll (N,) or (D, N) float32 (log_lik - max, <= 0, may hold -inf), dg
    (K,) or (D, K) float32 > 0 -> (s1, s2), each shaped like dg.

    CUDA tensors launch ``csrc/ladder.cu`` (one launch for all D
    populations); CPU tensors take :func:`ladder_stats_plain`.
    """
    if d_ll.device.type == "cpu":
        return ladder_stats_plain(d_ll, dg)
    if d_ll.device.type != "cuda":
        raise ValueError(f"unsupported device {d_ll.device}")
    dev = d_ll.device
    if d_ll.dim() not in (1, 2):
        raise ValueError(f"d_ll must be (N,) or (D, N), got "
                         f"{tuple(d_ll.shape)}")
    _build.check_input(d_ll, "d_ll", torch.float32, d_ll.dim(), dev)
    _build.check_input(dg, "dg", torch.float32, d_ll.dim(), dev)
    if dg.shape[:-1] != d_ll.shape[:-1]:
        raise ValueError(f"d_ll {tuple(d_ll.shape)} and dg {tuple(dg.shape)} "
                         "hold different numbers of populations")
    b = d_ll.shape[0] if d_ll.dim() == 2 else 1
    n, k = d_ll.shape[-1], dg.shape[-1]
    if n >= 2 ** 31 or k > _MAX_K or b > _MAX_B:
        raise ValueError(f"N must be < 2^31, K <= {_MAX_K} and D <= {_MAX_B}")
    lib = _build.load()
    # csrc/ladder.cu decides the grid; one (2, K) partial per block.
    partial = torch.empty((b, lib.ladder_blocks(n), 2, k),
                          dtype=torch.float32, device=dev)
    s1 = torch.empty_like(dg)
    s2 = torch.empty_like(dg)
    err = lib.ladder_launch(
        d_ll.data_ptr(), dg.data_ptr(), partial.data_ptr(), s1.data_ptr(),
        s2.data_ptr(), b, n, k, _build.stream_ptr(d_ll))
    _build.check(err, "ladder")
    _build.launch_counts["ladder"] += 1
    return s1, s2
