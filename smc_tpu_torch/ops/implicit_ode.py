"""Implicit (stiff) ODE and index-1 DAE integrator for user-defined models
(PyTorch port of ``smc_tpu.ops.implicit_ode``).

Any small dense system ``dy/dt = f(t, y)`` with ``y`` shaped (n, *batch),
particles on the last axis, gets a variable-step BDF2 march (BDF1 on the
very first substep) with a full Newton solve of a static iteration count:

- the per-lane (n, n) Jacobian comes from forward-mode tangents, n of
  them carried through one pass (the counterpart of ``jax.linearize``),
  unless the caller supplies analytic columns;
- the linear solve is the batch-last unrolled elimination with pairwise
  partial pivoting, ``ops/dae_fast.py::solve7(pivot=True)``;
- the max Newton residual over the trajectory comes back per lane, so a
  caller can mask non-converged particles to -inf log-likelihood.

Semi-explicit index-1 DAEs through ``alg_mask``: a row flagged algebraic
contributes ``0 = f_i(t, y)`` instead of ``dy_i/dt = f_i``, and
:func:`make_consistent` projects the algebraic components of y0 onto the
constraint manifold with the differential ones pinned (IDA's
``make_consistent('IDA_YA_YDP_INIT')``).

Everything is a Python loop of a static length over device ops: no host
read and no host-to-device copy, so a whole march captures into one CUDA
graph. The step coefficients stay 0-d device tensors, as the JAX
package's traced scalars are.
"""
from __future__ import annotations

from typing import Callable, Optional

import functools

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from smc_tpu_torch.ops.dae_fast import solve7


def _build_jac(f, t, y, n):
    """f at (t, y) and its per-lane Jacobian: (fv (n, *batch), J (n, n,
    *batch) with J[i, j] = d f_i / d y_j).

    The n tangent passes run as ONE forward-mode pass (dual tensors of
    ``torch.autograd.forward_ad``) over n stacked copies of the state,
    copy j carrying the tangent e_j: f must be elementwise over y's
    trailing axes (the layout the integrators ask of it), so each copy is
    the pass of its own tangent, and copy 0's primal is f(t, y). One pass
    instead of n keeps the host's cost per Newton iteration down (forward
    mode costs tens of microseconds per op on the host)."""
    ys = y[:, None].expand(n, n, *y.shape[1:]).contiguous()
    eye = torch.zeros_like(ys)
    for j in range(n):
        eye[j, j] = 1.0
    with fwAD.dual_level():
        out = fwAD.unpack_dual(f(t, fwAD.make_dual(ys, eye)))
    # .to: PyTorch's forward mode can promote a python float times a 0-d
    # tensor to float64; the Jacobian stays in y's dtype.
    return out.primal[:, 0], out.tangent.to(y.dtype)


def _f_and_jac(f, jac, t, y, n):
    """(f(t, y), J) from the forward-mode pass, or from the caller's
    analytic columns."""
    if jac is None:
        return _build_jac(f, t, y, n)
    return f(t, y), torch.stack(jac(t, y), dim=1)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """A small constant made once per device (never written): a copy from
    the host inside a march would break its graph capture."""
    return torch.tensor(values, dtype=dtype, device=device)


def _diag(m, like):
    """diag(m), (n, n), on ``like``'s device."""
    n = len(m)
    return _const(tuple(tuple(m[i] if i == j else 0.0 for j in range(n))
                        for i in range(n)), like.device, like.dtype)


def _col(m, like):
    return _const(tuple(m), like.device, like.dtype)


def _bcast(c, like):
    """``c`` with trailing unit axes up to ``like``'s rank."""
    return c.reshape(c.shape + (1,) * (like.dim() - c.dim()))


def _diff_mask(alg_mask, n):
    """Static per-row 1.0 (differential) / 0.0 (algebraic) multipliers."""
    if alg_mask is None:
        return [1.0] * n
    m = np.asarray(alg_mask)
    if m.shape != (n,):
        raise ValueError(f"alg_mask shape {m.shape} != ({n},)")
    return [0.0 if bool(a) else 1.0 for a in m]


def _newton_step(f, jac, t, y_iter, alpha, const, h, n, m):
    """One full-Newton update for the BDF system

        G_i(y) = m_i*(alpha*y_i + const_i) - h*f_i(t, y) = 0

    where m_i is the static differential/algebraic row multiplier (m_i = 0
    turns row i into the scaled algebraic constraint -h*f_i = 0; the h
    scaling keeps the Jacobian A = alpha*diag(m) - h*J uniformly
    conditioned for index-1 systems). Returns (y + delta, G)."""
    fv, J = _f_and_jac(f, jac, t, y_iter, n)
    # A = alpha*diag(m) - h*J, batch-last (n, n, *batch).
    A = _bcast(alpha * _diag(m, y_iter), J) - h * J
    g = _bcast(_col(m, y_iter), fv) * (alpha * y_iter + const) - h * fv
    delta = solve7(A, -g[:, None], pivot=True)[:, 0]
    return y_iter + delta, g


def make_consistent(f: Callable, y0: torch.Tensor, t0, alg_mask,
                    newton_iters: int = 8, jac: Optional[Callable] = None):
    """Project y0's ALGEBRAIC components onto f_alg(t0, y) = 0, the
    differential components pinned (Newton rows ``y_i - y0_i = 0``).

    Returns (y0_consistent, resid): resid is the per-lane max-abs algebraic
    residual of the returned iterate, shape ``batch``, for the same
    divergence mask as the integrator's residual."""
    n = y0.shape[0]
    m = _diff_mask(alg_mask, n)
    dm = _bcast(_diag(m, y0), y0[:, None])
    m_col = _bcast(_col(m, y0), y0)
    a_col = _bcast(_col([1.0 - mi for mi in m], y0), y0)
    y = y0
    for _ in range(newton_iters):
        fv, J = _f_and_jac(f, jac, t0, y, n)
        A = dm + a_col[:, None] * J
        g = m_col * (y - y0) + a_col * fv
        y = y + solve7(A, -g[:, None], pivot=True)[:, 0]
    res = torch.amax(torch.abs(a_col * f(t0, y)), dim=0)
    return y, res


def bdf2_grid(f: Callable, y0: torch.Tensor, ts: torch.Tensor,
              substeps: int = 4, newton_iters: int = 3,
              jac: Optional[Callable] = None, alg_mask=None):
    """Stiff-capable BDF2 on a fixed observation grid.

    f:  (t, y) -> dy/dt with y shaped (n, *batch), particles on the last
        axis.
    y0: (n, *batch) initial state at ts[0].
    ts: (T,) observation times on y0's device, strictly increasing;
        non-uniform grids are fine.
    jac: optional (t, y) -> [column_0, ..., column_{n-1}] analytic
        Jacobian columns (each (n, *batch)); default one forward-mode pass
        per Newton iteration over n stacked copies of the state
        (:func:`_build_jac`), which holds only for an f elementwise over
        every axis after the first, a copy axis inserted at axis 1
        included.
    alg_mask: optional static (n,) bools; True rows are ALGEBRAIC
        (``0 = f_i``). y0 must be consistent: use :func:`make_consistent`
        first.

    Returns (ys, max_resid): ys (T, n, *batch) with ys[0] == y0, and the
    max-abs Newton residual of each substep's LAST iteration over the
    whole trajectory, per lane (shape ``batch``; scaled by h:
    |m*(alpha*y + const) - h*f|).
    """
    n = y0.shape[0]
    m = _diff_mask(alg_mask, n)
    zero = torch.zeros((), dtype=y0.dtype, device=y0.device)
    res = torch.zeros(y0.shape[1:], dtype=y0.dtype, device=y0.device)
    ys = [y0]
    y_n = y_nm1 = y0
    h_prev = None                  # no step yet: BDF1, predictor y_n
    for k in range(ts.shape[0] - 1):
        t0, t1 = ts[k], ts[k + 1]
        h = (t1 - t0) / substeps
        for i in range(1, substeps + 1):
            t_sub = t0 + float(i) * h
            # Variable-step BDF2; BDF1 on the first global substep (same
            # formulation as ops/dae_fast.bdf_march_bl).
            r = zero if h_prev is None else h / h_prev
            alpha = (1.0 + 2.0 * r) / (1.0 + r)
            const = -(1.0 + r) * y_n + (r * r / (1.0 + r)) * y_nm1
            # Linear-extrapolation predictor (exact for the first: r = 0).
            y = y_n + r * (y_n - y_nm1)
            for _ in range(newton_iters - 1):
                y, _ = _newton_step(f, jac, t_sub, y, alpha, const, h, n, m)
            y, g = _newton_step(f, jac, t_sub, y, alpha, const, h, n, m)
            res = torch.maximum(res, torch.amax(torch.abs(g), dim=0))
            y_n, y_nm1, h_prev = y, y_n, h
        ys.append(y_n)
    return torch.stack(ys), res
