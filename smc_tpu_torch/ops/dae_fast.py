"""Batch-last (lanes-major) DAE engine (PyTorch port of
``smc_tpu.ops.dae_fast``).

Every array carries the flattened system batch B = n_particles x
n_conditions on the LAST axis, so one thread per lane reads and writes
neighbouring addresses. The sequential structure is the real data
dependence: time steps x Newton iterations x the NX-long block-Thomas
recurrence.

Pieces:
- ``solve7``: Gaussian elimination with (optional) pairwise-swap partial
  pivoting on (7, 7, B) / rhs (7, k, B), elementwise selects only.
- ``lu7_nopivot`` / ``lu7_solve`` / ``lu7_solve_T``: no-pivot LU and its
  solves, in the reference's operation order; ``lu7_pivot`` / ``lu7_pivot_solve``: LU with a stored permutation.
- ``block_thomas_factor`` / ``block_thomas_apply`` /
  ``block_thomas_apply_t``: the block-tridiagonal factor, its solve and the
  transposed system's solve with the same factors, as Python loops over
  NX. They are the plain versions of the CUDA kernels in
  ``ops/thomas_cuda.py``; the march on the card never calls them.
- ``block_thomas_babe_factor`` / ``_apply``: the two-ended elimination
  (both chains advance together, stacked on the lane axis);
  ``block_cr_factor`` / ``_apply``: block cyclic reduction.
- ``block_thomas_bl``: the pivoted fused solve of the conservative
  full-Newton path and of the steady adjoint (plain PyTorch; the reference
  has no kernel for it).
- ``bdf_march_bl``: BDF1/BDF2 march with per-step Newton and the IDA-style
  lagged Jacobian; ``steady_march_bl``: the steady state by per-lane
  switched-evolution-relaxation pseudo-transient continuation.

The small block algebra is written on slices of (7, 7, B) tensors. Per
entry the operations and their order are the reference's statically
unrolled ones. The plain loops are differentiable by autograd (the
transient likelihood's gradient on ``solver="thomas"``, ``"cr"``,
``"babe"``): where a tensor that autograd tracks would be written in place
after a view of it was saved, the helpers write into a copy instead (only
while autograd records; the values are the same). On ``"auto"`` /
``"thomas_pl"`` a march whose blocks or right-hand sides autograd tracks
factors the detached blocks with the factor kernel and solves through
``ops/thomas_cuda.py::block_thomas_solve_pl``, whose backward is the
transposed-solve kernel; untracked, it launches what it always did.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_f32 = np.float32

def _tracks(*ts) -> bool:
    """Whether autograd records operations on any of ``ts`` now."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _back_substitute(M, R, unit: bool = False):
    """x with M x = R for upper-triangular M (n, n, B), R (n, k, B): rows
    from the last up, ``acc * (1 / M[c, c])`` (no division for a unit
    diagonal). The rows are stacked at the end, so no row that a later one
    reads is written in place."""
    n = M.shape[0]
    xs = [None] * n
    for c in range(n - 1, -1, -1):
        acc = R[c]
        for cc in range(c + 1, n):
            acc = acc - M[c, cc] * xs[cc]
        xs[c] = acc if unit else acc * (1.0 / M[c, c])
    return torch.stack(xs)


def solve7(A: torch.Tensor, rhs: torch.Tensor, pivot: bool = True
           ) -> torch.Tensor:
    """Solve A X = rhs, A (n, n, B), rhs (n, k, B), batch on lanes.

    Partial pivoting by pairwise conditional row swaps (elementwise selects
    only), as the reference does it. A and rhs are held side by side, so a
    row swap and an elimination update each touch both in one op (half
    the launches); every entry's arithmetic is the reference's."""
    n = A.shape[0]
    grad = _tracks(A, rhs)
    MR = torch.cat([A, rhs], dim=1)                    # (n, n + k, B)
    for c in range(n):
        if pivot:
            for r in range(c + 1, n):
                swap = torch.abs(MR[r, c]) > torch.abs(MR[c, c])
                row_c = torch.where(swap, MR[r, c:], MR[c, c:])
                row_r = torch.where(swap, MR[c, c:], MR[r, c:])
                if grad:
                    MR = MR.clone()
                MR[c, c:] = row_c
                MR[r, c:] = row_r
        inv_p = 1.0 / MR[c, c]
        f = MR[c + 1:, c] * inv_p                      # (n-c-1, B)
        upd = f[:, None] * MR[c, c + 1:][None]
        if grad:
            MR = MR.clone()
        MR[c + 1:, c + 1:] -= upd
    return _back_substitute(MR[:, :n], MR[:, n:])


def lu7_nopivot(A: torch.Tensor) -> torch.Tensor:
    """LU factorization without pivoting, A (n, n, B) -> combined LU
    (unit-lower L below the diagonal, U on/above). Batch on lanes."""
    n = A.shape[0]
    grad = _tracks(A)
    M = A.clone()
    for c in range(n):
        inv_p = 1.0 / M[c, c]
        f = M[c + 1:, c] * inv_p
        upd = f[:, None] * M[c, c + 1:][None]
        if grad:
            M = M.clone()
        M[c + 1:, c] = f
        M[c + 1:, c + 1:] -= upd
    return M


def lu7_solve(LU: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L U) x = rhs from combined factors. rhs (n, k, B)."""
    n = LU.shape[0]
    grad = _tracks(LU, rhs)
    Y = rhs.clone()
    for c in range(n):           # forward: L y = rhs (unit diagonal)
        upd = LU[c + 1:, c][:, None] * Y[c][None]
        if grad:
            Y = Y.clone()
        Y[c + 1:] -= upd
    return _back_substitute(LU, Y)   # backward: U x = y


def lu7_solve_T(LU: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L U)^T x = rhs, i.e. U^T L^T x = rhs. rhs (n, k, B)."""
    n = LU.shape[0]
    grad = _tracks(LU, rhs)
    Y = rhs.clone()
    for c in range(n):           # forward: U^T y = rhs (lower tri, diag U)
        yc = Y[c] * (1.0 / LU[c, c])
        upd = LU[c, c + 1:][:, None] * yc[None]
        if grad:
            Y = Y.clone()
        Y[c] = yc
        Y[c + 1:] -= upd
    # backward: L^T x = y (unit diagonal); L^T's row c is LU's column c.
    return _back_substitute(LU.transpose(0, 1), Y, unit=True)


def lu7_pivot(A: torch.Tensor):
    """Partial-pivoting LU with a STORED permutation: A (n, n, B) ->
    (LU, P) with P A = L U, P a one-hot (n, n, B) permutation matrix.

    Pairwise conditional swaps of FULL rows (the computed L columns
    included, as LAPACK does, so the factors replay on any rhs). Needed
    where a raw diagonal block may be structurally unpivotable (the outlet
    boundary block couples u and T as a pure 2x2 permutation); the solve
    costs one extra matvec (y = P rhs) over the no-pivot path."""
    n = A.shape[0]
    grad = _tracks(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    MP = torch.cat([A, eye[:, :, None].expand(n, n, A.shape[2])], dim=1)
    for c in range(n):
        for r in range(c + 1, n):
            swap = torch.abs(MP[r, c]) > torch.abs(MP[c, c])
            row_c = torch.where(swap, MP[r], MP[c])
            row_r = torch.where(swap, MP[c], MP[r])
            if grad:
                MP = MP.clone()
            MP[c] = row_c
            MP[r] = row_r
        inv_p = 1.0 / MP[c, c]
        f = MP[c + 1:, c] * inv_p
        upd = f[:, None] * MP[c, c + 1:n][None]
        if grad:
            MP = MP.clone()
        MP[c + 1:, c] = f
        MP[c + 1:, c + 1:n] -= upd
    return MP[:, :n], MP[:, n:]


def lu7_pivot_solve(LU, P, rhs):
    """Solve with lu7_pivot factors: x = U^-1 L^-1 P rhs. rhs (n, k, B)."""
    pr = torch.sum(P[:, :, None, :] * rhs[None, :, :, :], dim=1)
    return lu7_solve(LU, pr)


def _matmul_bl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n,m,B) @ (m,k,B) -> (n,k,B): contraction over the small middle dim,
    batch broadcast on lanes."""
    return torch.sum(a[:, :, None, :] * b[None, :, :, :], dim=1)


def _matvec_bl(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(n,m,B) @ (m,B) -> (n,B)."""
    return torch.sum(a * v[None, :, :], dim=1)


def block_thomas_factor(A, B, C):
    """Factorization phase of the block-Thomas solve (no pivoting).

    A, B, C (NX, n, n, Bt) -> (LUs, ms): per-grid-point LU factors of the
    Schur-complement diagonal blocks and the elimination multipliers
    (ms[0] = 0), reusable for any number of right-hand sides."""
    nx = A.shape[0]
    LU = lu7_nopivot(B[0])
    LUs, ms = [LU], [torch.zeros_like(LU)]
    for i in range(1, nx):
        m = lu7_solve_T(LU, A[i].transpose(0, 1)).transpose(0, 1)
        LU = lu7_nopivot(B[i] - _matmul_bl(m, C[i - 1]))
        LUs.append(LU)
        ms.append(m)
    return torch.stack(LUs), torch.stack(ms)


def block_thomas_apply(LUs, ms, C, rhs):
    """Solve phase with stored factors: one forward rhs sweep and one
    back-substitution. rhs (NX, n, Bt) -> x (NX, n, Bt).

    Accepts column-padded factors, (n, ncol >= n, Bt) blocks: the pad
    columns are never read."""
    nx, nf = rhs.shape[0], rhs.shape[1]

    def blk(M):
        return M[:, :nf]
    x = torch.empty_like(rhs)
    rp = rhs[0]
    x[0] = rp                    # x holds rp on the way forward
    for i in range(1, nx):
        rp = rhs[i] - _matvec_bl(blk(ms[i]), rp)
        x[i] = rp
    xi = lu7_solve(blk(LUs[nx - 1]), rp[:, None, :])[:, 0, :]
    x[nx - 1] = xi
    for i in range(nx - 2, -1, -1):
        t = x[i] - _matvec_bl(blk(C[i]), xi)
        xi = lu7_solve(blk(LUs[i]), t[:, None, :])[:, 0, :]
        x[i] = xi
    return x


def block_thomas_apply_t(LUs, ms, C, g):
    """Solve the TRANSPOSED system M^T lam = g with the factors of
    :func:`block_thomas_factor` (no pivoting). g (NX, n, Bt) -> lam.

    The factors are M = L U: L has identity diagonal blocks and m_i below
    them, U has D_i (the matrix LU_i factors) on the diagonal and C_i above
    it. So M^T = U^T L^T, solved by a forward sweep
    z_0 = D_0^-T g_0, z_i = D_i^-T (g_i - C_{i-1}^T z_{i-1}), then a
    backward one: lam_last = z_last, lam_i = z_i - m_{i+1}^T lam_{i+1}.
    Accepts column-padded factors, as :func:`block_thomas_apply` does."""
    nx, nf = g.shape[0], g.shape[1]

    def blkT(M):                       # the (n, n, Bt) block, transposed
        return M[:, :nf].transpose(0, 1)
    lam = torch.empty_like(g)
    z = lu7_solve_T(LUs[0][:, :nf], g[0][:, None, :])[:, 0, :]
    lam[0] = z                   # lam holds z on the way forward
    for i in range(1, nx):
        t = g[i] - _matvec_bl(blkT(C[i - 1]), z)
        z = lu7_solve_T(LUs[i][:, :nf], t[:, None, :])[:, 0, :]
        lam[i] = z
    li = z
    for i in range(nx - 2, -1, -1):
        li = lam[i] - _matvec_bl(blkT(ms[i + 1]), li)
        lam[i] = li
    return lam


def _cat(t, b):
    return torch.cat([t, b], dim=-1)


def _swapT(M):
    return M.transpose(0, 1)


def block_thomas_babe_factor(A, B, C):
    """Twisted ("burn-at-both-ends") block-Thomas factorization.

    Eliminates from BOTH ends at once, the two recurrences meeting at row
    k = NX // 2: each step of the loop processes one top row and one
    bottom row as a single lane-stacked (7, 7, 2B) block op (the same
    algebra with the roles of A and C swapped for the upward direction):
    half the serial depth at equal work, twice the lanes per op.

    Head blocks are solved with full partial pivoting (``solve7``): the
    outlet rows make B[NX-1] a row-permuted identity whose no-pivot LU
    divides by zero. The interior Schur complements of both chains keep
    the no-pivot LU.

    Requires NX odd (the flagship grid is NX = 51) so the two chains are
    equal length; even NX raises ``ValueError``. Returns an opaque factor
    tuple for ``block_thomas_babe_apply``, reusable across right-hand
    sides."""
    nx = A.shape[0]
    if nx % 2 == 0:
        raise ValueError(f"babe solver requires odd NX, got {nx}")
    k = nx // 2

    # peeled head eliminations (pivoted): m_1 = A_1 B0^{-1},
    # w_{nx-2} = C_{nx-2} B_{nx-1}^{-1}, via the transposed systems
    m1 = _swapT(solve7(_swapT(B[0]), _swapT(A[1]), pivot=True))
    w1 = _swapT(solve7(_swapT(B[-1]), _swapT(C[nx - 2]), pivot=True))
    m_head = _cat(m1, w1)
    Bp1 = B[1] - _matmul_bl(m1, C[0])
    Bq1 = B[nx - 2] - _matmul_bl(w1, A[nx - 1])
    LU = lu7_nopivot(_cat(Bp1, Bq1))

    # stacked interior: top rows 2..k-1 | bottom rows nx-3..k+1
    X = _cat(A[2:k], C[k + 1:nx - 2].flip(0))
    Bs = _cat(B[2:k], B[k + 1:nx - 2].flip(0))
    Y = _cat(C[1:k - 1], A[k + 2:nx - 1].flip(0))
    LUs, ms = [LU], []
    for i in range(X.shape[0]):
        m = _swapT(lu7_solve_T(LU, _swapT(X[i])))
        LU = lu7_nopivot(Bs[i] - _matmul_bl(m, Y[i]))
        LUs.append(LU)
        ms.append(m)
    LU_all = torch.stack(LUs)          # rows 1..k-1 | nx-2..k+1
    ms = torch.stack(ms) if ms else LU_all[:0]

    # meeting-row epilogue: both chains eliminate into row k
    bsz = A.shape[-1]
    mk = _swapT(lu7_solve_T(LU, _swapT(_cat(A[k], C[k]))))         # m_k | w_k
    corr = _matmul_bl(mk, _cat(C[k - 1], A[k + 1]))
    LUk = lu7_nopivot(B[k] - corr[:, :, :bsz] - corr[:, :, bsz:])

    # back-substitution couplings: interior C_{k-1}..C_1 | A_{k+1}..A_{nx-2}
    G = _cat(C[1:k].flip(0), A[k + 1:nx - 1])
    # heads for the peeled final step (pivoted solve at apply time)
    heads = (B[0], B[-1], C[0], A[-1])
    return LU_all, ms, m_head, mk, LUk, G, heads


def block_thomas_babe_apply(fac, rhs):
    """Solve with stored BABE factors: both forward rhs sweeps as one
    half-depth lane-stacked loop, then the meeting-row solve, then both
    outward back-substitutions as one more half-depth loop (pivoted peeled
    steps at the two boundary rows). Results match ``block_thomas_apply``
    to fp32 reassociation."""
    LU_all, ms, m_head, mk, LUk, G, heads = fac
    B0, Bn, C0, An = heads
    nx = rhs.shape[0]
    k = nx // 2
    bsz = rhs.shape[-1]

    # peeled head step of the forward sweeps
    r_head = _cat(rhs[0], rhs[-1])                       # r_0 | r_{nx-1}
    rp = _cat(rhs[1], rhs[nx - 2]) - _matvec_bl(m_head, r_head)
    r_stack = _cat(rhs[2:k], rhs[k + 1:nx - 2].flip(0))
    rps = [rp]
    for i in range(r_stack.shape[0]):
        rp = r_stack[i] - _matvec_bl(ms[i], rp)
        rps.append(rp)
    # rps: rows 1..k-1 | nx-2..k+1

    corr = _matvec_bl(mk, rp)
    rk = rhs[k] - corr[:, :bsz] - corr[:, bsz:]
    xk = lu7_solve(LUk, rk[:, None, :])[:, 0, :]

    x = _cat(xk, xk)
    xs = []
    for t in range(len(rps)):
        i = len(rps) - 1 - t
        x = lu7_solve(LU_all[i], (rps[i] - _matvec_bl(G[t], x))[:, None, :]
                  )[:, 0, :]
        xs.append(x)
    # xs[t] = x_{k-1-t} | x_{k+1+t}, covering rows k-1..1 | k+1..nx-2
    # peeled boundary rows (pivoted): x_0 and x_{nx-1}
    x1 = x[:, :bsz]                                      # x_1
    xm = x[:, bsz:]                                      # x_{nx-2}
    x0 = solve7(B0, (rhs[0] - _matvec_bl(C0, x1))[:, None, :],
                pivot=True)[:, 0, :]
    xn = solve7(Bn, (rhs[-1] - _matvec_bl(An, xm))[:, None, :],
                pivot=True)[:, 0, :]
    x_top = [v[:, :bsz] for v in xs[::-1]]               # x_1..x_{k-1}
    x_bot = [v[:, bsz:] for v in xs]                     # x_{k+1}..x_{nx-2}
    return torch.stack([x0] + x_top + [xk] + x_bot + [xn])


# --------------------------------------------------------------------------
# Block cyclic reduction: a log-depth alternative to the block-Thomas
# sweep. At each level all EVEN-indexed rows are eliminated at once (each
# substituted into its two odd neighbours), recursing on the odd rows: a
# system of size (m-1)/2, which stays 2^j - 1 when NX is padded to 2^k - 1
# with decoupled identity blocks (safe: the caller zeroes A[0] and C[-1]).
#
# The JAX package maps its (7, 7, B) helpers over the level's rows with
# vmap; here the row axis is folded into the lane axis instead,
# (m, 7, 7, B) -> (7, 7, m*B), so the same helpers serve unchanged.
# --------------------------------------------------------------------------

def _fold(X: torch.Tensor) -> torch.Tensor:
    """(m, a, b, B) -> (a, b, m*B), or (m, a, B) -> (a, m*B)."""
    return X.movedim(0, -2).reshape(*X.shape[1:-1], -1)


def _unfold(X: torch.Tensor, m: int) -> torch.Tensor:
    """The inverse of :func:`_fold` for m rows."""
    return X.reshape(*X.shape[:-1], m, -1).movedim(-2, 0)


def _blu(Bm, pivot):
    """LU of each of the m blocks of Bm (m, 7, 7, B), folded on the lane
    axis: (LU, P or None), each (7, 7, m*B)."""
    if pivot:
        return lu7_pivot(_fold(Bm))
    return lu7_nopivot(_fold(Bm)), None


def _bsolve(LUP, r):
    """Solve each block's system: r (m, 7, k, B) -> (m, 7, k, B)."""
    LU, P = LUP
    m = r.shape[0]
    rf = _fold(r)
    x = lu7_solve(LU, rf) if P is None else lu7_pivot_solve(LU, P, rf)
    return _unfold(x, m)


def _bsolve_vec(LUP, r):
    return _bsolve(LUP, r[:, :, None, :])[:, :, 0, :]


def _bmm(a, b):
    """(m,7,7,B) x (m,7,7,B) blockwise."""
    return torch.sum(a[:, :, :, None, :] * b[:, None, :, :, :], dim=2)


def _bmv(a, v):
    """(m,7,7,B) x (m,7,B) blockwise."""
    return torch.sum(a * v[:, None, :, :], dim=2)


def _cr_pad(A, B, C, nx):
    """Pad the row axis to m = 2^k - 1 with decoupled identity blocks."""
    m = 1
    while m < nx:
        m = 2 * m + 1
    if m == nx:
        return A, B, C, m
    pad = m - nx
    eye = torch.eye(B.shape[1], dtype=B.dtype, device=B.device)
    eye = eye[None, :, :, None].expand((pad,) + B.shape[1:])
    zero = A.new_zeros((pad,) + A.shape[1:])
    return (torch.cat([A, zero]), torch.cat([B, eye]),
            torch.cat([C, zero]), m)


def block_cr_factor(A, B, C):
    """Cyclic-reduction factorization of a block-tridiagonal system.

    A/B/C: (NX, n, n, Bt) with A[0] == 0 and C[-1] == 0 (caller-folded,
    the contract of block_thomas_factor). Returns an opaque factor tuple
    for ``block_cr_apply``: per level the eliminated (even-row) LUs and
    propagators P = inv(B)A, Q = inv(B)C, the surviving odd rows' original
    off-diagonals, and the root LU. Level 0 factors the RAW diagonal
    blocks, which may be structurally unpivotable (the outlet boundary
    block is a pure u/T permutation): stored-pivot LU. Deeper levels
    factor Schur-updated blocks: no pivot."""
    nx = A.shape[0]
    A, B, C, m = _cr_pad(A, B, C, nx)
    levels = []
    level = 0
    while m > 1:
        # even rows 0,2,..,m-1 are eliminated; odd rows 1,3,..,m-2 survive.
        A_ev, B_ev, C_ev = A[0::2], B[0::2], C[0::2]
        A_od, C_od = A[1::2], C[1::2]
        LUP = _blu(B_ev, pivot=(level == 0))
        P = _bsolve(LUP, A_ev)                     # inv(B_i) A_i
        Q = _bsolve(LUP, C_ev)                     # inv(B_i) C_i
        levels.append((LUP, P, Q, A_od, C_od))
        # Surviving row 2p+1 couples to eliminated rows 2p (P[p], Q[p]) and
        # 2p+2 (P[p+1], Q[p+1]):  x_even = s - P x_left - Q x_right.
        B = B[1::2] - _bmm(A_od, Q[:-1]) - _bmm(C_od, P[1:])
        A = -_bmm(A_od, P[:-1])
        C = -_bmm(C_od, Q[1:])
        m = A.shape[0]
        level += 1
    root = lu7_pivot(B[0])
    return (tuple(levels), root, nx)


def block_cr_apply(factors, rhs):
    """Solve with stored cyclic-reduction factors. rhs (NX, n, Bt)."""
    levels, root, nx = factors
    m = levels[0][1].shape[0] * 2 - 1 if levels else 1
    if m != nx:
        rhs = torch.cat([rhs, rhs.new_zeros((m - nx,) + rhs.shape[1:])])
    r = rhs
    stash = []
    for LUP, P, Q, A_od, C_od in levels:
        s = _bsolve_vec(LUP, r[0::2])
        stash.append(s)
        r = r[1::2] - _bmv(A_od, s[:-1]) - _bmv(C_od, s[1:])
    x = lu7_pivot_solve(root[0], root[1], r[0][:, None, :])[:, 0, :][None]
    for (LUP, P, Q, _, _), s in zip(reversed(levels), reversed(stash)):
        z = torch.zeros_like(x[:1])
        x_ev = (s - _bmv(P, torch.cat([z, x]))
                - _bmv(Q, torch.cat([x, z])))
        inter = torch.stack([x_ev[:-1], x], dim=1)
        x = torch.cat([inter.reshape((-1,) + x.shape[1:]), x_ev[-1:]])
    return x[:nx]


def block_thomas_bl(A, B, C, rhs, pivot: bool = True):
    """Block-tridiagonal solve, batch-last. A/B/C: (NX,7,7,Bt), rhs (NX,7,Bt).

    A[0] and C[-1] must already be folded/zeroed by the caller.
    """
    nx = A.shape[0]
    Bps, rps = [B[0]], [rhs[0]]
    for i in range(1, nx):
        # m = A_i inv(Bp_prev):  m^T = solve(Bp_prev^T, A_i^T)
        mT = solve7(Bps[-1].transpose(0, 1), A[i].transpose(0, 1),
                    pivot=pivot)
        m = mT.transpose(0, 1)
        Bps.append(B[i] - _matmul_bl(m, C[i - 1]))
        rps.append(rhs[i] - _matvec_bl(m, rps[-1]))
    xi = solve7(Bps[-1], rps[-1][:, None, :], pivot=pivot)[:, 0, :]
    xs = [xi]
    for i in range(nx - 2, -1, -1):
        t = rps[i] - _matvec_bl(C[i], xi)
        xi = solve7(Bps[i], t[:, None, :], pivot=pivot)[:, 0, :]
        xs.append(xi)
    return torch.stack(xs[::-1])


SOLVERS = ("thomas", "thomas_pl", "cr", "babe")


def resolve_solver(solver: str) -> str:
    """Resolve the "auto" solver choice.

    "auto" -> "thomas_pl", the hand-written block-Thomas kernels
    (``ops/thomas_cuda.py``), on any device; on the CPU their wrappers take
    the plain loops, so the arithmetic is that of "thomas". This differs
    from the JAX package, whose "auto" is its XLA scan: that choice rests
    on a fusion measurement of one TPU generation and says nothing about
    this card. In eager PyTorch the loop over NX rows of 7x7 block algebra
    is thousands of small launches per solve, so here both the factor and
    the applies go through the kernels. "thomas", "cr" (block cyclic
    reduction) and "babe" (two-ended block-Thomas, odd NX) are plain
    PyTorch on any device."""
    if solver == "auto":
        return "thomas_pl"
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of "
                         f"{('auto',) + SOLVERS}")
    return solver


def _tangent_blocks(rows_bl, args, slots, ncol):
    """The Jacobian blocks of ``slots`` (argument positions of rows_bl) by
    forward-mode AD: one tangent per (slot, field), all of them in ONE
    pass (``torch.func.vmap`` of ``torch.func.jvp`` over the stacked
    tangents; the reference makes one ``jax.linearize`` pass per column).
    Returns {slot: (7, ncol, NX, B)}, block columns past the field count
    zero. The closures of rows_bl (the conditions, the kinetic lanes) stay
    unbatched, so vmap broadcasts them; stacking the copies on the lane
    axis instead would need rows_bl to know of the copies."""
    from torch.func import jvp, vmap
    y = args[1]
    nf = y.shape[0]
    k = len(slots) * nf
    # Tangent j = (slot index j // nf, field j % nf): e_field on that
    # slot, zero on the others.
    onehot = torch.eye(nf, dtype=y.dtype, device=y.device)[:, :, None, None]
    onehot = onehot.expand(nf, nf, *y.shape[1:])            # (nf, 7, NX, B)
    zero = y.new_zeros(()).expand(nf, *y.shape)
    tangents = [torch.cat([onehot if slots[i] == s else zero
                           for i in range(len(slots))])
                if s in slots else y.new_zeros(()).expand(k, *y.shape)
                for s in range(4)]

    def column(*t):
        return jvp(rows_bl, tuple(args), t)[1]

    cols = vmap(column)(*tangents).to(y.dtype)           # (k, 7, NX, B)
    out = {}
    for i, s in enumerate(slots):
        blk = cols[i * nf:(i + 1) * nf].transpose(0, 1)  # (7, nf, NX, B)
        if ncol > nf:
            blk = torch.cat([blk, blk.new_zeros(
                (blk.shape[0], ncol - nf) + blk.shape[2:])], dim=1)
        out[s] = blk
    return out


def _newton_kit(rows_bl: Callable, y0: torch.Tensor, pivot: bool,
                analytic_jac: Optional[Callable], solver: str):
    """Shared closures for the implicit solvers: residual evaluation,
    Jacobian block assembly, and the solver-dispatched block-tridiagonal
    factor/apply pair. The BDF mass term is parameterized as
    yd = (alpha*y + const)/h; alpha=1, const=-y, h a (B,) tensor is the
    steady march's pseudo-step. Returns (shift, residual, build_blocks,
    factor_, apply_). The JAX package's sixth closure, ``factor_apply_``,
    serves its ``_FUSED_FACTOR`` experiment, which is not ported (ROADMAP):
    here a factor step is ``factor_`` then ``apply_``.

    ``analytic_jac(y_m, y, y_p, yd) -> {slot: block}`` may supply any of
    the four slots; the others are built by tangent passes
    (:func:`_tangent_blocks`), so ``analytic_jac=None`` means all 28.

    The blocks keep the column width ``analytic_jac`` gives them. The
    reference pads 7 -> 8 columns for its Pallas kernels because their row
    DMAs must be sublane-aligned; that pad has no meaning on this card, so
    nothing is padded here and the model emits 7 columns. A callback that
    does emit 8 columns gets 8-column factors back (zero pad column) and
    the padded-factor apply kernel; tangent-built slots are padded to the
    analytic slots' width."""
    nf = y0.shape[0]

    def shift(y):
        y_m = torch.cat([y[:, :1], y[:, :-1]], dim=1)
        y_p = torch.cat([y[:, 1:], y[:, -1:]], dim=1)
        return y_m, y_p

    def neg_rows(F):
        # -F as the sweeps' right-hand side (NX, 7, B), contiguous: one pass
        # (out= has no autograd, so a tracked F takes two).
        if _tracks(F):
            return (-F).movedim(1, 0).contiguous()
        rhs = F.new_empty((F.shape[1], F.shape[0], F.shape[2]))
        return torch.neg(F.movedim(1, 0), out=rhs)

    def residual(y, alpha, const, h):
        y_m, y_p = shift(y)
        yd = (alpha * y + const) / h
        return neg_rows(rows_bl(y_m, y, y_p, yd))

    def build_blocks(y, alpha, const, h):
        y_m, y_p = shift(y)
        yd = (alpha * y + const) / h
        blocks = dict(analytic_jac(y_m, y, y_p, yd)) if analytic_jac else {}
        need = [s for s in range(4) if s not in blocks]
        if need:
            ncol = next(iter(blocks.values())).shape[1] if blocks else nf
            blocks.update(_tangent_blocks(rows_bl, (y_m, y, y_p, yd), need,
                                          ncol))
        F = rows_bl(y_m, y, y_p, yd)
        A_, B_, C_, D_ = blocks[0], blocks[1], blocks[2], blocks[3]
        B_ = B_ + D_ * (alpha / h)
        # (7,ncol,NX,B) -> (NX,7,ncol,B), the layout of the sweeps; no copy
        # when the callback assembled its blocks grid-major.
        A_, B_, C_ = (M.movedim(2, 0).contiguous() for M in (A_, B_, C_))
        # Fold the duplicated edge slots, in place: the blocks are this
        # call's own (the callback returns fresh tensors).
        B_[0] += A_[0]
        B_[-1] += C_[-1]
        A_[0] = 0.0
        C_[-1] = 0.0
        return A_, B_, C_, neg_rows(F)

    def factor_(A_, B_, C_):
        # "thomas": the plain loops; "thomas_pl": one CUDA kernel for the
        # whole NX recurrence of all lanes (its plain version on the CPU);
        # "cr": cyclic reduction; "babe": the two-ended sweep.
        if solver == "thomas_pl":
            from smc_tpu_torch.ops.thomas_cuda import block_thomas_factor_pl
            if _tracks(A_, B_, C_):
                # The kernel factors the detached blocks; the applies take
                # the tracked ones beside the factors, for their backward.
                LUs, ms, Cd = block_thomas_factor_pl(
                    A_.detach(), B_.detach(), C_.detach())
                return LUs, ms, Cd, (A_, B_, C_)
            return block_thomas_factor_pl(A_, B_, C_)
        A_, B_, C_ = A_[:, :, :nf], B_[:, :, :nf], C_[:, :, :nf]
        if solver == "cr":
            return block_cr_factor(A_, B_, C_)
        if solver == "babe":
            return block_thomas_babe_factor(A_, B_, C_)
        LUs, ms = block_thomas_factor(A_, B_, C_)
        return (LUs, ms, C_)

    def apply_(fac, rhs):
        if solver == "cr":
            delta = block_cr_apply(fac, rhs)
        elif solver == "babe":
            delta = block_thomas_babe_apply(fac, rhs)
        elif solver == "thomas_pl":
            from smc_tpu_torch.ops.thomas_cuda import block_thomas_solve_pl
            LUs, ms, C_ = fac[:3]
            # The apply kernel of the factors' width; under a gradient its
            # backward is the transposed kernel. The blocks only route the
            # gradient, so untracked factors stand in for them.
            A_, B_, Ct = fac[3] if len(fac) == 4 else (C_, C_, C_)
            delta = block_thomas_solve_pl(A_, B_, Ct, LUs, ms, rhs)
        else:
            delta = block_thomas_apply(*fac, rhs)
        return delta.movedim(0, 1)

    return shift, residual, build_blocks, factor_, apply_


def bdf_march_bl(rows_bl: Callable,
                 y0: torch.Tensor,
                 dts,
                 newton_iters: int = 3,
                 order: int = 2,
                 pivot: bool = True,
                 analytic_jac: Callable = None,
                 jac_stride: int = 1,
                 n_dense: int = None,
                 reuse_iters: int = None,
                 dense_tail: int = 0,
                 solver: str = "thomas") -> torch.Tensor:
    """March F(y, y') = 0 in batch-last layout. y0: (7, NX, B).

    rows_bl(y_m, y, y_p, yd) -> (7, NX, B) residual rows, where y_m/y_p are
    the neighbor-shifted states (edge-duplicated; the duplicated boundary
    Jacobian contributions are folded into the diagonal blocks here).

    analytic_jac(y_m, y, y_p, yd) -> {slot: (7, ncol, NX, B)} supplies
    closed-form Jacobian blocks for any of the four argument slots (0 =
    y_m, 1 = y, 2 = y_p, 3 = yd), fresh tensors on every call; the other
    slots are built by tangent passes (None: all four).

    dts is the step schedule, a host array (NumPy or a sequence): the BDF
    coefficients are float32 scalars computed on the host and enter the
    device ops as scalars, so the march never waits for the device.

    jac_stride > 1 (modified-Newton path only) enables IDA-style Jacobian
    lag ACROSS time steps. After ``n_dense`` leading per-step-factored steps
    (default: the lagged step count modulo jac_stride), the march proceeds
    in blocks of ``jac_stride`` steps: the Jacobian is built and
    block-Thomas-factored once at block entry, and the remaining steps of
    the block solve with the stale factors, each Newton update scaled by
    IDA's mass-coefficient compensation c = 2 / (1 + cj_step / cj_factored)
    (exactly 1 when the step size is constant within the block). Reuse
    steps run ``reuse_iters`` Newton iterations (default newton_iters + 1).
    The residual is always evaluated with the step's true coefficients, so
    a converged step is exact regardless of factor staleness. The last
    ``dense_tail`` steps factor per step again.
    """
    solver = resolve_solver(solver)
    _, residual, build_blocks, factor_, apply_ = _newton_kit(
        rows_bl, y0, pivot, analytic_jac, solver)
    if isinstance(dts, torch.Tensor):
        if dts.device.type != "cpu":
            raise ValueError("dts must be a host array: reading a device "
                             "tensor would make every march wait for the "
                             "device")
        dts = dts.detach().numpy()
    dts = np.asarray(dts, _f32)
    one, two = _f32(1.0), _f32(2.0)

    def ratio(h, h_prev, is_first):
        return _f32(0.0) if is_first else _f32(h / h_prev)

    def coeffs(y_n, y_nm1, h, h_prev, is_first):
        if order == 2:
            r = ratio(h, h_prev, is_first)
            alpha = (one + two * r) / (one + r)
            const = float(-(one + r)) * y_n \
                + float(r * r / (one + r)) * y_nm1
        else:
            alpha = one
            const = -y_n
        return alpha, const

    def step(carry, h, is_first):
        y_n, y_nm1, h_prev = carry
        alpha, const = coeffs(y_n, y_nm1, h, h_prev, is_first)
        a, hh = float(alpha), float(h)
        if pivot:
            # Conservative path: full Newton with pivoted fused Thomas.
            y = y_n
            for _ in range(newton_iters):
                A_, B_, C_, rhs = build_blocks(y, a, const, hh)
                delta = block_thomas_bl(A_, B_, C_, rhs, pivot=True)
                y = y + delta.movedim(0, 1)
        else:
            # Modified Newton: build + factorize the block-tridiagonal
            # Jacobian ONCE per time step (at the BDF predictor y_n) and
            # reuse the factors for every iteration.
            A_, B_, C_, rhs = build_blocks(y_n, a, const, hh)
            fac = factor_(A_, B_, C_)
            y = y_n + apply_(fac, rhs)
            for _ in range(newton_iters - 1):
                y = y + apply_(fac, residual(y, a, const, hh))
        return (y, y_n, h)

    n_steps = dts.shape[0]
    carry = (y0, y0, dts[0])

    if pivot or jac_stride <= 1:
        for k in range(n_steps):
            carry = step(carry, dts[k], k == 0)
        return carry[0]

    # ---- IDA-style lagged-Jacobian march (modified Newton only) ----------
    n_lag = n_steps - dense_tail
    if n_dense is None:
        n_dense = n_lag % jac_stride
    if (n_lag - n_dense) % jac_stride != 0:
        raise ValueError(f"lagged steps {n_lag - n_dense} not divisible by "
                         f"jac_stride={jac_stride}")
    if reuse_iters is None:
        reuse_iters = newton_iters + 1
    for k in range(n_dense):
        carry = step(carry, dts[k], k == 0)

    def predictor(y_n, y_nm1, h, h_prev, is_first):
        # IDA-style polynomial predictor: linear extrapolation of the last
        # two solutions.
        r = ratio(h, h_prev, is_first)
        return y_n + float(r) * (y_n - y_nm1)

    for k0 in range(n_dense, n_lag, jac_stride):
        y_n, y_nm1, h_prev = carry
        # factor step: build + factor at the predictor, newton_iters updates.
        h = dts[k0]
        alpha, const = coeffs(y_n, y_nm1, h, h_prev, k0 == 0)
        y0_pred = predictor(y_n, y_nm1, h, h_prev, k0 == 0)
        a, hh = float(alpha), float(h)
        A_, B_, C_, rhs = build_blocks(y0_pred, a, const, hh)
        fac = factor_(A_, B_, C_)
        cj_f = alpha / h
        y = y0_pred + apply_(fac, rhs)
        for _ in range(newton_iters - 1):
            y = y + apply_(fac, residual(y, a, const, hh))
        y_n, y_nm1, h_prev = y, y_n, h
        # reuse steps: stale factors + cj compensation.
        for j in range(1, jac_stride):
            h = dts[k0 + j]
            alpha, const = coeffs(y_n, y_nm1, h, h_prev, False)
            c = float(two / (one + (alpha / h) / cj_f))
            a, hh = float(alpha), float(h)
            y = predictor(y_n, y_nm1, h, h_prev, False)
            for _ in range(reuse_iters):
                y = y + c * apply_(fac, residual(y, a, const, hh))
            y_n, y_nm1, h_prev = y, y_n, h
        carry = (y_n, y_nm1, h_prev)

    # Per-step-factored tail: the observable is the final state, so the
    # last steps get fresh factors regardless of the lag economy.
    for k in range(n_lag, n_steps):
        carry = step(carry, dts[k], k == 0)
    return carry[0]


def steady_march_bl(rows_bl: Callable,
                    y0: torch.Tensor,
                    n_steps: int = 20,
                    h0: float = 0.02,
                    h_max: float = 1e6,
                    grow_cap: float = 6.0,
                    grow_floor: float = 2.0,
                    lag: int = 1,
                    reuse_iters: int = 2,
                    newton_iters: int = 1,
                    pivot: bool = False,
                    analytic_jac: Callable = None,
                    solver: str = "thomas",
                    conv_tol: float = 1e-4) -> torch.Tensor:
    """Solve the steady state F(y, yd=0) = 0 directly. y0: (7, NX, B).

    Pseudo-transient continuation with per-lane switched-evolution
    relaxation (SER): each BDF1 pseudo-step solves ``F(y', (y' - y)/h) =
    0`` by modified Newton from the predictor y (Levenberg-regularized
    Newton on the steady system with damping D/h), and each LANE's h
    evolves by the SER rule ``h_k = h_{k-1} * ||F(y_{k-1}, 0)|| /
    ||F(y_k, 0)||`` (clipped to [1/4, grow_cap^lag], capped at h_max). h is
    a (B,) tensor broadcast into the mass term. As a lane's residual
    collapses its h reaches h_max and the iteration becomes plain Newton.

    The steady residual norm driving SER is free: at the BDF1 predictor
    yd = 0, so the rhs ``build_blocks`` returns IS -F(y, 0).

    Per pseudo-step: one build and factor, ``newton_iters`` applies, then
    ``lag - 1`` reuses of the factors at the same h with ``reuse_iters``
    applies each. The loops have a fixed length and read nothing on the
    host, so a march captures into one CUDA graph. ``pivot`` only selects
    the padded layout in the reference; the march itself never pivots.

    Failure containment: lanes not converged at the last step
    (steady-residual norm above ``conv_tol`` relative to the lane's
    initial residual norm, or non-finite) are set to NaN, so callers'
    -10000 sentinels fire. A lane whose step produces non-finite values
    keeps its previous iterate and retries at h/4.
    """
    solver = resolve_solver(solver)
    _, residual, build_blocks, factor_, apply_ = _newton_kit(
        rows_bl, y0, pivot, analytic_jac, solver)

    def lane_norm(rhs):                           # rhs (NX, 7, B)
        return torch.amax(torch.abs(rhs), dim=(0, 1))

    cap, floor = float(grow_cap) ** lag, float(grow_floor) ** lag
    h = torch.full((y0.shape[-1],), h0, dtype=y0.dtype, device=y0.device)
    r0 = lane_norm(residual(y0, 1.0, -y0, 1.0))          # = |F(y0, 0)|
    y, r_prev = y0, r0
    for _ in range(n_steps):
        A_, B_, C_, rhs = build_blocks(y, 1.0, -y, h)    # rhs = -F(y, 0)
        r = lane_norm(rhs)                               # (B,)
        fac = factor_(A_, B_, C_)
        y1 = y + apply_(fac, rhs)
        for _ in range(newton_iters - 1):
            y1 = y1 + apply_(fac, residual(y1, 1.0, -y, h))
        # Jacobian lag: lag-1 more BDF1 steps at the SAME h reuse the
        # factors (the factored mass coefficient is exact; only J(y) is
        # stale). h then grows by grow_floor^lag per pseudo-step.
        for _ in range(1, lag):
            base = y1
            for _ in range(reuse_iters):
                y1 = y1 + apply_(fac, residual(y1, 1.0, -base, h))
        bad = ~torch.isfinite(torch.amax(torch.abs(y1), dim=(0, 1)))  # (B,)
        ratio = torch.clamp(r_prev / torch.clamp_min(r, 1e-30), 0.25, cap)
        # Growth floor: pure SER stalls on this problem's long ignition
        # plateau (ratio ~= 1 for most of the pseudo-time traverse). While
        # the step is healthy, advance at least geometrically.
        ratio = torch.where(ratio > 0.9, torch.clamp_min(ratio, floor),
                            ratio)
        h = torch.where(bad, h * 0.25, torch.clamp_max(h * ratio, h_max))
        y = torch.where(bad[None, None, :], y, y1)
        r_prev = r

    # Convergence certificate: final steady residual small relative to the
    # lane's initial residual (r0 also fixes the per-lane unit scale).
    r_end = lane_norm(residual(y, 1.0, -y, 1.0))
    ok = torch.isfinite(r_end) & (r_end < conv_tol * (r0 + 1.0))
    return torch.where(ok[None, None, :], y, torch.nan)
