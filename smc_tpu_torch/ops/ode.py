"""Fixed-grid RK4 (PyTorch port of ``smc_tpu.ops.ode.rk4_grid``).

A Python loop over the observation intervals with ``substeps`` classic RK4
steps each; the state is a whole batch (for example (n_datasets, N)), so
every stage is one elementwise op over all particles.
"""
from __future__ import annotations

from typing import Callable

import torch


def _rk4_step(f, t, y, h):
    k1 = f(t, y)
    k2 = f(t + 0.5 * h, y + 0.5 * h * k1)
    k3 = f(t + 0.5 * h, y + 0.5 * h * k2)
    k4 = f(t + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4_grid(f: Callable, y0: torch.Tensor, ts: torch.Tensor,
             substeps: int = 4) -> torch.Tensor:
    """Classic RK4 on a fixed observation grid. Returns (len(ts), *y0.shape);
    the first row is y0."""
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        h = (t1 - t0) / substeps
        for s in range(substeps):
            y = _rk4_step(f, t0 + s * h, y, h)
        ys.append(y)
    return torch.stack(ys)
