"""Gamma-ladder weight sums: CUDA kernel and plain version.

Port of ``smc_tpu/ops/ladder_pallas.py`` (``ladder_stats``): for K candidate
increments dg_k,

    s1[k] = sum_i exp(d_ll[i] * dg[k]),   s2[k] = sum_i exp(d_ll[i] * dg[k])^2

in one pass over the particles. ``find_gamma`` forms the normalized ESS
s1^2 / (s2 N) of every candidate from them. -inf entries contribute 0 while
dg > 0. The kernel is ``csrc/ladder.cu``, one launch: per-block partial
sums, which the last block of each candidate group adds in a fixed order
(no fp32 atomics), so the result is the same on every run.

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

# The kernel's tickets: one int32 counter per (population, candidate group),
# zero between launches (the kernel sets each back to 0 when it is done
# with it), so they are allocated zeroed once per device and reused by every
# call and every replay of a captured graph. A larger need allocates a
# larger buffer; the old ones stay alive, since a captured graph may still
# point at them. Calls on one device share them, so two ladder launches must
# not run at once on two streams (the port runs its steps on one).
_tickets = {}


def _ticket_counters(device: torch.device, count: int) -> torch.Tensor:
    held = _tickets.setdefault(device, [])
    if not held or held[-1].numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "ladder_stats: its ticket counters must be allocated before "
                "a CUDA graph capture; call it once at this shape first")
        held.append(torch.zeros(max(count, 4096), dtype=torch.int32,
                                device=device))
    return held[-1]


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
    # csrc/ladder.cu decides the grid: blocks x candidate groups x
    # populations, each block with 16 partial sums.
    groups = lib.ladder_groups(k)
    partial = torch.empty((b, groups, lib.ladder_blocks(n), 16),
                          dtype=torch.float32, device=dev)
    tickets = _ticket_counters(dev, b * groups)
    s1 = torch.empty_like(dg)
    s2 = torch.empty_like(dg)
    err = lib.ladder_launch(
        d_ll.data_ptr(), dg.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, n, k,
        _build.stream_ptr(d_ll))
    _build.check(err, "ladder")
    _build.launch_counts["ladder"] += 1
    return s1, s2
