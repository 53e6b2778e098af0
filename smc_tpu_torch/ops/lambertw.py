"""Principal-branch Lambert W (PyTorch port of ``smc_tpu.ops.lambertw``).

Used by the closed-form Michaelis-Menten solution
S(t) = Km * W((S0/Km) e^{(S0 - Vmax t)/Km}) (the ``exact`` likelihood) and by
data generation. Arguments are z >= 0, where Halley's iteration from a
log1p-based initializer reaches fp32 precision in 3 steps; 4 run for margin.
"""
from __future__ import annotations

import math

import torch


def lambertw(z: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Principal branch W0(z) for z >= 0, elementwise, fixed iterations."""
    lz = torch.log(torch.clamp_min(z, 1e-30))
    l1 = torch.log1p(z)
    w = torch.where(z > math.e,
                    lz - torch.log(torch.clamp_min(lz, 1e-30)),
                    l1 * (1.0 - torch.log1p(l1) / (2.0 + l1)))
    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - z
        # Halley update; denominator guarded for w -> -1 (never hit, z >= 0).
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        w = w - f / torch.where(torch.abs(denom) < 1e-30,
                                torch.full_like(denom, 1e-30), denom)
    return w
