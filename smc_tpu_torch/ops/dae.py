"""Implicit DAE integrator: BDF1/BDF2 + block-tridiagonal Newton (PyTorch
port of ``smc_tpu.ops.dae``, the per-system "blocked" engine).

Method-of-lines DAEs F(t, y, y') = 0 whose Jacobian is block-tridiagonal
in the grid index (each grid point couples only to its neighbours) are
marched over a fixed step schedule; each Newton system is solved by a
block-Thomas recurrence over the grid, its 7x7 blocks through
``ops/linalg.py::solve_small``. Everything is fixed-iteration and
fixed-shape: divergence propagates as non-finite values that the caller
masks.

This engine is the oracle of the lanes-major engine (``ops/dae_fast.py``,
which runs the block-Thomas CUDA kernels). It stays independent of it:
its local Jacobian blocks come from ``torch.func.jacfwd`` under
``torch.func.vmap`` over the grid points (as ``jax.jacfwd`` under
``jax.vmap`` in the JAX package), not from the lanes-major engine's
analytic blocks, and its block solves are its own.

Batching: every array may carry leading batch dims, one DAE system each
(the JAX package maps the per-system function with ``vmap``); the per-point
residual is mapped over systems x grid points in one ``vmap`` call.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from smc_tpu_torch.ops.linalg import solve_small


def geometric_schedule(t_final: float, n_steps: int, growth: float = 1.3
                       ) -> np.ndarray:
    """Step sizes dt_k = dt0 * growth^k summing exactly to t_final."""
    g = float(growth)
    w = g ** np.arange(n_steps)
    return (t_final * w / w.sum()).astype(np.float32)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., b, b) @ (..., b) -> (..., b)."""
    return (m @ v[..., None])[..., 0]


def block_thomas_solve(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """Solve a block-tridiagonal system: blocks (..., NX, b, b), rhs
    (..., NX, b), leading dims a batch of independent systems.

    Row i:  A[i] x[i-1] + B[i] x[i] + C[i] x[i+1] = rhs[i]
    (A[0] and C[-1] ignored). A Python loop over NX; the b x b solves use
    the pivoted elimination of ops/linalg.py."""
    nx = A.shape[-3]
    Bps, rps = [B[..., 0, :, :]], [rhs[..., 0, :]]
    for i in range(1, nx):
        # m = A_i @ inv(Bp_prev), computed as a solve on the transpose
        m = solve_small(Bps[-1].transpose(-1, -2),
                        A[..., i, :, :].transpose(-1, -2)).transpose(-1, -2)
        Bps.append(B[..., i, :, :] - m @ C[..., i - 1, :, :])
        rps.append(rhs[..., i, :] - _mv(m, rps[-1]))
    xs = [None] * nx
    xs[-1] = solve_small(Bps[-1], rps[-1])
    for i in range(nx - 2, -1, -1):
        xs[i] = solve_small(Bps[i], rps[i] - _mv(C[..., i, :, :], xs[i + 1]))
    return torch.stack(xs, dim=-2)


def implicit_euler_dae(local_rows: Callable,
                       y0: torch.Tensor,
                       flags: torch.Tensor,
                       dts: torch.Tensor,
                       newton_iters: int = 3,
                       order: int = 2,
                       aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """March F(y, y') = 0 over the dt schedule with BDF1/BDF2.

    order=1: implicit Euler, y' = (y - y_n)/h.
    order=2: variable-step BDF2 (BDF1 startup step): with r = h_n/h_{n-1},
        y' = [ (1+2r)/(1+r) y  -  (1+r) y_n  +  r^2/(1+r) y_{n-1} ] / h_n.

    local_rows(y_prev, y_cur, y_next, yd_cur, flags_i[, aux_i]) -> (b,)
    residual rows at one grid point; it must depend only on the neighbour
    states (block-tridiagonal structure). flags: (NX, f) per-row feature
    vector (boundary kinds). y0: (..., NX, b), leading dims a batch of
    systems. aux: optional (..., a) per-system parameters, passed to
    local_rows as its sixth argument (the JAX package's rows close over
    them under its vmap over systems). dts: (n_steps,) tensor on y0's
    device. Each step starts Newton from y_n.

    Boundary slots: grid point 0 receives y_prev = y_cur, point NX-1
    receives y_next = y_cur; their Jacobian contributions are folded into
    the diagonal block accordingly. Returns the final state, y0's shape.
    """
    *batch, nx, b = y0.shape
    fl = flags.expand(*batch, nx, flags.shape[-1]).reshape(-1,
                                                           flags.shape[-1])
    args = (fl,)
    if aux is not None:
        args += (aux[..., None, :].expand(*batch, nx, aux.shape[-1])
                 .reshape(-1, aux.shape[-1]),)
    rows = torch.func.vmap(local_rows)
    jac_local = torch.func.vmap(torch.func.jacfwd(local_rows,
                                                  argnums=(0, 1, 2, 3)))

    def newton_update(y, alpha, const, h):
        yd = (alpha * y + const) / h
        y_m = torch.cat([y[..., :1, :], y[..., :-1, :]], dim=-2)
        y_p = torch.cat([y[..., 1:, :], y[..., -1:, :]], dim=-2)
        pts = [t.reshape(-1, b) for t in (y_m, y, y_p, yd)]
        F = rows(*pts, *args).reshape(y.shape)
        # .to: PyTorch's forward mode promotes a python float times a 0-d
        # element to float64 under vmap; the blocks stay in y's dtype.
        A, B, C, D = (t.reshape(*batch, nx, b, b).to(y.dtype)
                      for t in jac_local(*pts, *args))
        B = B + D * (alpha / h)
        # Fold the duplicated boundary slots into the diagonal blocks.
        B[..., 0, :, :] += A[..., 0, :, :]
        B[..., -1, :, :] += C[..., -1, :, :]
        A[..., 0, :, :] = 0.0
        C[..., -1, :, :] = 0.0
        return y + block_thomas_solve(A, B, C, -F)

    y_n = y_nm1 = y0
    h_prev = None                  # no step yet: BDF1
    for k in range(dts.shape[0]):
        h = dts[k]
        if order == 2:
            r = torch.zeros_like(h) if h_prev is None else h / h_prev
            alpha = (1.0 + 2.0 * r) / (1.0 + r)
            const = -(1.0 + r) * y_n + (r * r / (1.0 + r)) * y_nm1
        else:
            alpha = torch.ones_like(h)
            const = -y_n
        y = y_n
        for _ in range(newton_iters):
            y = newton_update(y, alpha, const, h)
        y_n, y_nm1, h_prev = y, y_n, h
    return y_n
