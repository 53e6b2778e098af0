"""Batched small-matrix linear solves (PyTorch port of
``smc_tpu.ops.linalg``).

Gaussian elimination with partial pivoting on (..., n, n) systems, batched
over the leading dims, as a statically unrolled loop of elementwise and
gather ops: the same elimination order and the same 1e-30 guard on a zero
pivot as the JAX package's. It is the inner solve of the per-system
(blocked) DAE engine (ops/dae.py), the oracle of the lanes-major engine.
"""
from __future__ import annotations

import torch


def _guard(piv: torch.Tensor) -> torch.Tensor:
    return torch.where(piv == 0, 1e-30, piv)


def solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small static n with partial pivoting.

    A: (..., n, n), b: (..., n) or (..., n, k). Batched over leading dims.
    """
    vec = b.dim() == A.dim() - 1
    if vec:
        b = b[..., None]
    n = A.shape[-1]
    M = torch.cat([A, b], dim=-1)                  # (..., n, n+k)
    rows = torch.arange(n, device=A.device)

    for k in range(n):
        # Partial pivot: row with max |M[.., j, k]| among j >= k.
        col = torch.where(rows >= k, torch.abs(M[..., :, k]), -torch.inf)
        pk = torch.argmax(col, dim=-1, keepdim=True)   # (..., 1)
        # Swap rows k <-> p (batched permutation gather).
        perm = torch.where(rows == k, pk, torch.where(rows == pk, k, rows))
        M = torch.take_along_dim(M, perm[..., None], dim=-2)
        # Eliminate below the pivot.
        factor = M[..., :, k] / _guard(M[..., k, k][..., None])
        mask = (rows > k).to(M.dtype)
        M = M - (mask * factor)[..., None] * M[..., k:k + 1, :]

    # Back substitution (unrolled).
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        rhs = M[..., k, n:]
        if k + 1 < n:
            rhs = rhs - torch.einsum("...j,...jk->...k", M[..., k, k + 1:n],
                                     torch.stack(xs[k + 1:], dim=-2))
        xs[k] = rhs / _guard(M[..., k, k][..., None])
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x
