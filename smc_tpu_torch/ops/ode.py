"""Fixed-grid explicit ODE integrators (PyTorch port of
``smc_tpu.ops.ode``).

A Python loop over the observation intervals with a static number of
substeps each; the state is a whole batch (for example (n_datasets, N)),
so every stage is one elementwise op over all particles, and the loop has
no data-dependent control flow (it captures into a CUDA graph).

- :func:`rk4_grid`: classic RK4.
- :func:`dopri5_grid`: the Dormand-Prince 5(4) pair on the same fixed
  substeps, with its embedded error estimate. As in the JAX package, that
  estimate is ONE scalar: the max of |y5 - y4| over every component of the
  whole batch, particles included, and over the trajectory. A caller that
  masks on it (``ODEModel`` with a finite ``err_tol``) masks every
  particle when one diverges; the port keeps that, being held to the
  reference.
"""
from __future__ import annotations

from typing import Callable

import torch


def _scan_grid(step1, f, y0, ts, substeps):
    """``step1`` over the observation intervals with ``substeps`` substeps
    each: (ys (len(ts), *y0.shape) with ys[0] == y0, the max of the steps'
    error estimates, None for a step that returns none)."""
    ys = [y0]
    y, err = y0, None
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        h = (t1 - t0) / substeps
        for s in range(substeps):
            y, e = step1(f, t0 + s * h, y, h)
            if e is not None:
                err = e if err is None else torch.maximum(err, e)
        ys.append(y)
    return torch.stack(ys), err


def _rk4_step(f, t, y, h):
    k1 = f(t, y)
    k2 = f(t + 0.5 * h, y + 0.5 * h * k1)
    k3 = f(t + 0.5 * h, y + 0.5 * h * k2)
    k4 = f(t + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None


# Dormand-Prince 5(4) tableau (same family as scipy solve_ivp's "RK45").
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _dopri5_step(f, t, y, h):
    ks = []
    for i in range(7):
        yi = y
        for a, k in zip(_DP_A[i], ks):
            yi = yi + h * a * k
        ks.append(f(t + _DP_C[i] * h, yi))
    y5 = y
    y4 = y
    for b5, b4, k in zip(_DP_B5, _DP_B4, ks):
        y5 = y5 + h * b5 * k
        y4 = y4 + h * b4 * k
    # The batch-wide max (the module's text).
    return y5, torch.max(torch.abs(y5 - y4))


def rk4_grid(f: Callable, y0: torch.Tensor, ts: torch.Tensor,
             substeps: int = 4) -> torch.Tensor:
    """Classic RK4 on a fixed observation grid. Returns (len(ts), *y0.shape);
    the first row is y0."""
    return _scan_grid(_rk4_step, f, y0, ts, substeps)[0]


def dopri5_grid(f: Callable, y0: torch.Tensor, ts: torch.Tensor,
                substeps: int = 2):
    """Dormand-Prince 5(4) on a fixed grid. Returns (ys, max_err): the
    5th-order solution at every grid point, (len(ts), *y0.shape), and the
    max embedded-error estimate over the whole batch and trajectory, a 0-d
    tensor (the divergence flag)."""
    return _scan_grid(_dopri5_step, f, y0, ts, substeps)
