"""Run diagnostics helpers (PyTorch port of ``smc_tpu.smc.diagnostics``)."""
from __future__ import annotations

import torch

FAILURE_SENTINEL = -10000.0


def normalized_ess(weights: torch.Tensor) -> torch.Tensor:
    """ESS / N for normalized weights."""
    n = weights.shape[0]
    return 1.0 / (torch.sum(weights * weights) * n)


def unique_ancestor_fraction(ancestors: torch.Tensor) -> torch.Tensor:
    """Fraction of distinct particles surviving resampling: a particle
    survives iff it received at least one offspring slot. Out-of-range
    indices are dropped."""
    n = ancestors.shape[0]
    a = ancestors.long()
    a = a[(a >= 0) & (a < n)]
    hit = torch.zeros(n, dtype=torch.int32, device=ancestors.device)
    hit[a] = 1
    return torch.sum(hit) / n


def failed_solve_count(flows: torch.Tensor) -> torch.Tensor:
    """Number of (particle, condition) simulator failures, identified by the
    -10000 sentinel. flows (..., 5, n_data)."""
    failed = torch.all(flows == FAILURE_SENTINEL, dim=-2)
    return torch.sum(failed)
