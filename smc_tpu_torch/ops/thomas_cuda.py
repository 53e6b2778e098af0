"""Block-Thomas factor and apply: CUDA kernels and plain versions.

Port of ``smc_tpu/ops/thomas_pallas.py``. A block-tridiagonal system of NX
rows of 7x7 blocks is solved for each of B lanes (the lane axis is last):

- factor: LU_0 = lu(B_0); m_i = A_i LU_{i-1}^{-1};
  LU_i = lu(B_i - m_i C_{i-1}), no-pivot Doolittle LU, m_0 = 0;
- apply: rp_0 = r_0, rp_i = r_i - m_i rp_{i-1}; x_last = LU^{-1} rp;
  x_i = LU_i^{-1} (rp_i - C_i x_{i+1}).

The kernels are ``csrc/thomas_factor.cu``, ``csrc/thomas_apply.cu`` and
``csrc/thomas_apply_t.cu`` (the transposed solve M^T lam = g with the same
factors): one thread per lane, the NX recurrence a loop inside the thread,
the rows staged through a ring in shared memory by asynchronous copies, at
any B (the ragged tail is masked). The plain versions are the Python loops
of ``ops/dae_fast.py``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

Gradients: :func:`block_thomas_solve_pl` is the one route autograd takes
through these kernels. It is a ``torch.autograd.Function`` that takes the
blocks beside their factors: forward, x = M^-1 rhs by the apply kernel;
backward, lam = M^-T x_bar by the transposed kernel, the rhs's cotangent,
and the blocks' cotangents -lam_i x_{i-1}^T, -lam_i x_i^T,
-lam_i x_{i+1}^T. The factor and the two applies take no tracked input
(``ValueError`` on every device, so that no solve drops its share of the
gradient without a word): factors alone do not know the blocks they came
from, so an apply from factors cannot say what the blocks' cotangents are.

Column pad: the TPU kernels want 8-column blocks (sublane-aligned row
DMAs). That has no meaning on this card, so nothing here needs the pad. It
is kept as a layout the wrappers understand, so that padded factors mean
the same in both packages: ``block_thomas_factor_pl`` returns factors at
the column width of its input (7 in, 7 out; 8 in, 8 out with a zero eighth
column), ``block_thomas_apply_pl`` takes 8-column factors (7-column ones are
padded per call, as the reference does) and ``block_thomas_apply_tiled``
takes 7-column ones.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from smc_tpu_torch.ops import _build
# The solve's plain version is the loop itself: pad columns are never read.
from smc_tpu_torch.ops.dae_fast import \
    block_thomas_apply as block_thomas_apply_plain
from smc_tpu_torch.ops.dae_fast import \
    block_thomas_apply_t as block_thomas_apply_t_plain
from smc_tpu_torch.ops.dae_fast import block_thomas_factor

NF = 7       # fields per grid point: the kernels unroll 7x7 blocks
_SUB = 8     # the padded column count


def _pad_cols(M: torch.Tensor) -> torch.Tensor:
    pad = _SUB - M.shape[2]
    return F.pad(M, (0, 0, 0, pad)) if pad > 0 else M


def pad_blocks(A, B, C):
    """Column-pad raw (NX, 7, 7, B) block arrays to (NX, 7, 8, B)."""
    return _pad_cols(A), _pad_cols(B), _pad_cols(C)


def pad_factors(LUs, ms, C):
    """Column-pad (NX, 7, 7, B) factors to (NX, 7, 8, B), the layout
    ``block_thomas_apply_pl`` takes."""
    return _pad_cols(LUs), _pad_cols(ms), _pad_cols(C)


def block_thomas_factor_plain(A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """The factor by the plain loops, at the column width of the input."""
    ncol = A.shape[2]
    LUs, ms = block_thomas_factor(A[:, :, :NF], B[:, :, :NF], C[:, :, :NF])
    if ncol != NF:
        LUs, ms = F.pad(LUs, (0, 0, 0, ncol - NF)), \
            F.pad(ms, (0, 0, 0, ncol - NF))
    return LUs, ms


def kernel_info(name: str, nx: int) -> dict:
    """What the occupancy calculator says of a kernel launched at ``nx``
    grid rows on the current card: ``name`` is ``thomas_factor`` (7-column
    blocks), ``thomas_apply``, ``thomas_apply_tiled`` or ``thomas_apply_t``
    (7-column factors). Builds the library if needed."""
    entry, cs = {"thomas_factor": ("thomas_factor_info", NF),
                 "thomas_apply": ("thomas_apply_info", _SUB),
                 "thomas_apply_tiled": ("thomas_apply_info", NF),
                 "thomas_apply_t": ("thomas_apply_t_info", NF)}[name]
    out = (ctypes.c_int * 5)()
    _build.check(getattr(_build.load(), entry)(cs, nx, out), entry)
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "spill_bytes", "lanes_per_block"), out))


def _refuse_tracked(name, *ts):
    """Raise ValueError when autograd records and any of ``ts`` requires
    grad: this wrapper has no backward, and its plain stand-in must not
    differentiate where the card could not."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(
            f"{name}: an input requires grad, but this wrapper has no "
            "backward; differentiate a solve through block_thomas_solve_pl("
            "A, B, C, LUs, ms, rhs), which takes the blocks beside their "
            "factors, or detach")


def _check_blocks(name, M, nx, ncol, b, dev):
    _build.check_input(M, name, torch.float32, 4, dev)
    if tuple(M.shape) != (nx, NF, ncol, b):
        raise ValueError(f"{name} must be {(nx, NF, ncol, b)}, got "
                         f"{tuple(M.shape)}")


def block_thomas_factor_pl(A, B, C):
    """A, B, C (NX, 7, ncol, B) float32 with ncol 7 or 8 -> (LUs, ms, C):
    LUs and ms (NX, 7, ncol, B), ms[0] = 0, the eighth column zero where
    there is one; C is passed through for the applies.

    CUDA tensors launch ``csrc/thomas_factor.cu``; CPU tensors take
    :func:`block_thomas_factor_plain`. A[0] and C[-1] are never read.
    """
    if A.dim() != 4 or A.shape[1] != NF or A.shape[2] not in (NF, _SUB):
        raise ValueError(f"blocks must be (NX, {NF}, {NF} or {_SUB}, B), "
                         f"got {tuple(A.shape)}")
    _refuse_tracked("block_thomas_factor_pl", A, B, C)
    if A.device.type == "cpu":
        LUs, ms = block_thomas_factor_plain(A, B, C)
        return LUs, ms, C
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    nx, _, ncol, b = A.shape
    for name, M in (("A", A), ("B", B), ("C", C)):
        _check_blocks(name, M, nx, ncol, b, A.device)
    LUs, ms = torch.empty_like(A), torch.empty_like(A)
    if b > 0:
        err = _build.load().thomas_factor_launch(
            A.data_ptr(), B.data_ptr(), C.data_ptr(), LUs.data_ptr(),
            ms.data_ptr(), nx, b, ncol, _build.stream_ptr(A))
        _build.check(err, "thomas_factor")
        _build.launch_counts["thomas_factor"] += 1
    return LUs, ms, C


def _apply(name, ncol, LUs, ms, C, rhs):
    dev = rhs.device
    _build.check_input(rhs, "rhs", torch.float32, 3, dev)
    nx, nf, b = rhs.shape
    if nf != NF:
        raise ValueError(f"rhs must be (NX, {NF}, B), got {tuple(rhs.shape)}")
    for nm, M in (("LUs", LUs), ("ms", ms), ("C", C)):
        _check_blocks(nm, M, nx, ncol, b, dev)
    x = torch.empty_like(rhs)
    if b > 0:
        fn = getattr(_build.load(), f"{name}_launch")
        err = fn(LUs.data_ptr(), ms.data_ptr(), C.data_ptr(),
                 rhs.data_ptr(), x.data_ptr(), nx, b, _build.stream_ptr(rhs))
        _build.check(err, name)
        _build.launch_counts[name] += 1
    return x


def block_thomas_apply_pl(LUs, ms, C, rhs) -> torch.Tensor:
    """Solve with stored column-padded factors: LUs, ms, C (NX, 7, 8, B),
    rhs (NX, 7, B) float32 -> x (NX, 7, B). Unpadded factors are padded
    here, per call.

    CUDA tensors launch the stride-8 entry point of
    ``csrc/thomas_apply.cu``; CPU tensors take
    :func:`block_thomas_apply_plain`.
    """
    _refuse_tracked("block_thomas_apply_pl", LUs, ms, C, rhs)
    if rhs.device.type == "cpu":
        return block_thomas_apply_plain(LUs, ms, C, rhs)
    if rhs.device.type != "cuda":
        raise ValueError(f"unsupported device {rhs.device}")
    if LUs.dim() == 4 and LUs.shape[2] == NF:
        LUs, ms, C = pad_factors(LUs, ms, C)
    return _apply("thomas_apply", _SUB, LUs, ms, C, rhs)


def block_thomas_apply_tiled(LUs, ms, C, rhs) -> torch.Tensor:
    """The same solve on unpadded factors: LUs, ms, C (NX, 7, 7, B), rhs
    (NX, 7, B) float32 -> x (NX, 7, B).

    CUDA tensors launch the stride-7 entry point of
    ``csrc/thomas_apply.cu``; CPU tensors take
    :func:`block_thomas_apply_plain`.
    """
    if LUs.dim() != 4 or LUs.shape[2] != NF:
        raise ValueError(f"factors must be (NX, {NF}, {NF}, B), got "
                         f"{tuple(LUs.shape)}")
    _refuse_tracked("block_thomas_apply_tiled", LUs, ms, C, rhs)
    if rhs.device.type == "cpu":
        return block_thomas_apply_plain(LUs, ms, C, rhs)
    if rhs.device.type != "cuda":
        raise ValueError(f"unsupported device {rhs.device}")
    return _apply("thomas_apply_tiled", NF, LUs, ms, C, rhs)


def block_thomas_apply_t_pl(LUs, ms, C, g) -> torch.Tensor:
    """Solve the transposed system M^T lam = g with the factors of
    :func:`block_thomas_factor_pl`: LUs, ms, C (NX, 7, ncol, B) with ncol 7
    or 8, g (NX, 7, B) float32 -> lam (NX, 7, B).

    CUDA tensors launch ``csrc/thomas_apply_t.cu`` at the factors' column
    stride; CPU tensors take :func:`block_thomas_apply_t_plain`. No
    backward (the backward pass of :func:`block_thomas_solve_pl` calls it).
    """
    if LUs.dim() != 4 or LUs.shape[1] != NF or LUs.shape[2] not in (NF, _SUB):
        raise ValueError(f"factors must be (NX, {NF}, {NF} or {_SUB}, B), "
                         f"got {tuple(LUs.shape)}")
    _refuse_tracked("block_thomas_apply_t_pl", LUs, ms, C, g)
    if g.device.type == "cpu":
        return block_thomas_apply_t_plain(LUs, ms, C, g)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    dev = g.device
    _build.check_input(g, "g", torch.float32, 3, dev)
    nx, nf, b = g.shape
    ncol = LUs.shape[2]
    if nf != NF:
        raise ValueError(f"g must be (NX, {NF}, B), got {tuple(g.shape)}")
    for nm, M in (("LUs", LUs), ("ms", ms), ("C", C)):
        _check_blocks(nm, M, nx, ncol, b, dev)
    lam = torch.empty_like(g)
    if b > 0:
        err = _build.load().thomas_apply_t_launch(
            LUs.data_ptr(), ms.data_ptr(), C.data_ptr(), g.data_ptr(),
            lam.data_ptr(), nx, b, ncol, _build.stream_ptr(g))
        _build.check(err, "thomas_apply_t")
        _build.launch_counts["thomas_apply_t"] += 1
    return lam


def _c_like(C, LUs):
    """C at the factors' column width: the apply reads it beside them."""
    C = C[:, :, :LUs.shape[2]]
    return (_pad_cols(C) if C.shape[2] < LUs.shape[2] else C).contiguous()


def _solve(LUs, ms, C, rhs):
    """x = M^-1 rhs from the factors, by the entry point of their width:
    stride 7 for unpadded factors, 8 for padded ones (the plain loops on
    the CPU)."""
    if LUs.shape[2] == NF:
        return block_thomas_apply_tiled(LUs, ms, C, rhs)
    return block_thomas_apply_pl(LUs, ms, C, rhs)


class _Solve(torch.autograd.Function):
    """x = M^-1 rhs for the block-tridiagonal M of the blocks A, B, C, by
    the stored factors of M; its vector-Jacobian product by the transposed
    solve (module text)."""

    @staticmethod
    def forward(ctx, A, B, C, LUs, ms, rhs):
        Cf = _c_like(C.detach(), LUs)
        x = _solve(LUs, ms, Cf, rhs.detach())
        ctx.save_for_backward(LUs, ms, Cf, x)
        ctx.widths = (A.shape[2], B.shape[2], C.shape[2])
        return x

    @staticmethod
    def backward(ctx, x_bar):
        LUs, ms, C, x = ctx.saved_tensors
        lam = block_thomas_apply_t_pl(LUs, ms, C, x_bar.contiguous())
        need = ctx.needs_input_grad
        nx, nf, b = lam.shape
        nl = -lam

        def outer(rows_l, rows_x, unread, ncol):
            # -lam_i x_j^T for the block rows i of rows_l; zero in the row
            # the solve never reads and in the pad column: (NX, 7, ncol, B)
            g = lam.new_empty((nx, nf, ncol, b))
            torch.mul(nl[rows_l, :, None, :], x[rows_x, None, :, :],
                      out=g[rows_l, :, :nf])
            if ncol > nf:
                g[:, :, nf:] = 0.0
            if unread is not None:
                g[unread] = 0.0
            return g
        every, lo, hi = slice(None), slice(1, None), slice(None, -1)
        wa, wb, wc = ctx.widths
        gA = outer(lo, hi, 0, wa) if need[0] else None
        gB = outer(every, every, None, wb) if need[1] else None
        gC = outer(hi, lo, -1, wc) if need[2] else None
        return gA, gB, gC, None, None, lam if need[5] else None


def block_thomas_solve_pl(A, B, C, LUs, ms, rhs) -> torch.Tensor:
    """x = M^-1 rhs, differentiable: A, B, C (NX, 7, 7 or 8, B) the blocks
    of M (A[0] and C[-1] never read), LUs, ms (NX, 7, 7 or 8, B) the
    factors :func:`block_thomas_factor_pl` made of them (detached: the
    factors take no gradient), rhs (NX, 7, B) float32. Each cotangent has
    its block's width.

    Forward: the apply kernel at the factors' column stride (7: the tiled
    entry, 8: the padded one). Backward: lam = M^-T x_bar by
    ``csrc/thomas_apply_t.cu``, the rhs's cotangent lam, and the blocks'
    -lam_i x_{i-1}^T (A, i >= 1), -lam_i x_i^T (B), -lam_i x_{i+1}^T
    (C, i <= NX - 2), zero in the pad column and the unread blocks. When
    one set of factors serves several solves (the lagged march), autograd
    adds each solve's block cotangents. CPU tensors take the plain loops
    both ways, at any float dtype. Untracked inputs give the apply's own
    result and launches, with nothing saved."""
    for nm, M in (("LUs", LUs), ("ms", ms)):
        if M.requires_grad:
            raise ValueError(f"block_thomas_solve_pl: {nm} requires grad; "
                             "factor detached blocks")
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (A, B, C, rhs))):
        return _solve(LUs, ms, _c_like(C, LUs), rhs)
    return _Solve.apply(A, B, C, LUs, ms, rhs)
