"""Block-Thomas factor and apply: CUDA kernels and plain versions.

Port of ``smc_tpu/ops/thomas_pallas.py``. A block-tridiagonal system of NX
rows of 7x7 blocks is solved for each of B lanes (the lane axis is last):

- factor: LU_0 = lu(B_0); m_i = A_i LU_{i-1}^{-1};
  LU_i = lu(B_i - m_i C_{i-1}), no-pivot Doolittle LU, m_0 = 0;
- apply: rp_0 = r_0, rp_i = r_i - m_i rp_{i-1}; x_last = LU^{-1} rp;
  x_i = LU_i^{-1} (rp_i - C_i x_{i+1}).

The kernels are ``csrc/thomas_factor.cu`` and ``csrc/thomas_apply.cu``: one
thread per lane, the NX recurrence a loop inside the thread, the rows staged
through a ring in shared memory by asynchronous copies, at any B (the
ragged tail is masked). The plain versions are the Python loops of
``ops/dae_fast.py``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. The kernels have no backward, so an input
that autograd tracks is refused on every device (``ValueError``): the
solve would otherwise drop its share of the gradient without a word.

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
    blocks), ``thomas_apply`` or ``thomas_apply_tiled``. Builds the library
    if needed."""
    entry, cs = {"thomas_factor": ("thomas_factor_info", NF),
                 "thomas_apply": ("thomas_apply_info", _SUB),
                 "thomas_apply_tiled": ("thomas_apply_info", NF)}[name]
    out = (ctypes.c_int * 5)()
    _build.check(getattr(_build.load(), entry)(cs, nx, out), entry)
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "spill_bytes", "lanes_per_block"), out))


def _refuse_tracked(name, *ts):
    """Raise ValueError when autograd records and any of ``ts`` requires
    grad: the kernels have no backward, and their plain stand-ins must not
    differentiate where the card could not."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(
            f"{name}: an input requires grad, but the CUDA block-Thomas "
            "kernels have no backward, as the JAX package's Pallas kernels "
            "have none; use solver='thomas' (the plain loops) or detach")


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
