"""The methanation march's residual rows and Newton-system blocks: CUDA
kernels and plain versions.

Two kernels (``csrc/march.cu``) compute, for each lane, what the BDF2
march's Newton loop asks of the model:

- ``march_rows(y, const, alpha, h, flags, condv, kin) -> rhs``: -F at
  yd = (alpha*y + const)/h, in the sweeps' layout (NX, 7, B);
- ``march_blocks(...) -> (A, B, C, rhs)``: the closed-form Jacobian blocks
  of ``models/methanation.py::_analytic_full_jac`` with B already holding
  D*alpha/h and the duplicated edge slots folded, (NX, 7, 7, B) each, and
  the same rhs.

y and const are (7, NX, B) float32, flags (3, NX, 1) (inlet, first
interior, outlet), condv (5, B), kin (8, B), h a float or a (B,) tensor
(the steady march's per-lane pseudo-step). Their plain versions are the
PyTorch composition the march runs without the kernels
(``ops/dae_fast.py::newton_residual`` and ``newton_blocks`` with the
model's rows and closed-form Jacobian). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Neither kernel has a
backward, so the wrappers refuse inputs that autograd tracks.

:class:`MarchKernels` is what the model hands the marches: the pair bound
to one problem's flags, conditions and kinetics, and the rule of when a
Newton call takes it (``takes``): float32 inputs that autograd does not
track. Everything else, and the 8-column layout and the tangent-built
Jacobian modes (for which the model makes no pair), keeps the PyTorch
composition.
"""
from __future__ import annotations

import torch

from smc_tpu_torch.ops import _build
from smc_tpu_torch.ops.dae_fast import (_tracks, newton_blocks,
                                        newton_residual)

NF = 7


def _problem(flags, condv, kin):
    """(rows, jac) of the methanation model at these lanes (imported here:
    the model's module imports this one)."""
    from smc_tpu_torch.models.methanation import _analytic_full_jac, _rows_bl

    def rows(y_m, y, y_p, yd):
        return _rows_bl(y_m, y, y_p, yd, flags, condv, kin)
    return rows, _analytic_full_jac(flags, condv, kin)


def march_rows_plain(y, const, alpha, h, flags, condv, kin):
    """The residual by PyTorch operations: -F (NX, 7, B)."""
    rows, _ = _problem(flags, condv, kin)
    return newton_residual(rows, y, alpha, const, h)


def march_blocks_plain(y, const, alpha, h, flags, condv, kin):
    """The Newton system by PyTorch operations: (A, B, C, rhs)."""
    rows, jac = _problem(flags, condv, kin)
    return newton_blocks(rows, jac, y, alpha, const, h)


def _check(y, const, alpha, h, flags, condv, kin):
    """The kernels' inputs, checked; returns (h_lane or None, 1/h,
    alpha/h): over a scalar h both in the host's double, rounded to
    float32 as PyTorch rounds the plain version's ``/ h`` (a multiply by
    the reciprocal) and ``D * (alpha / h)``."""
    dev = y.device
    for name, t in (("y", y), ("const", const)):
        _build.check_input(t, name, torch.float32, 3, dev)
    nf, nx, b = y.shape
    if nf != NF or tuple(const.shape) != (NF, nx, b):
        raise ValueError(f"y and const must be ({NF}, NX, B), got "
                         f"{tuple(y.shape)} and {tuple(const.shape)}")
    _build.check_input(condv, "condv", torch.float32, 2, dev)
    _build.check_input(kin, "kin", torch.float32, 2, dev)
    if tuple(condv.shape) != (5, b) or tuple(kin.shape) != (8, b):
        raise ValueError(f"condv and kin must be (5, {b}) and (8, {b}), got "
                         f"{tuple(condv.shape)} and {tuple(kin.shape)}")
    if flags.device != dev or flags.dtype != torch.float32 \
            or tuple(flags.shape) != (3, nx, 1):
        raise ValueError(f"flags must be float32 (3, {nx}, 1) on {dev}")
    if torch.is_tensor(h):
        _build.check_input(h, "h", torch.float32, 1, dev)
        if h.shape[0] != b:
            raise ValueError(f"h must be ({b},), got {tuple(h.shape)}")
        return h, 1.0, 0.0
    return None, 1.0 / float(h), float(alpha) / float(h)


def _refuse_tracked(name, *ts):
    if _tracks(*(t for t in ts if torch.is_tensor(t))):
        raise ValueError(f"{name}: an input requires grad, but this kernel "
                         "has no backward; the march's PyTorch composition "
                         "differentiates")


def _launch(name, outs, y, const, alpha, h, flags, condv, kin):
    hl, rh, coef = _check(y, const, alpha, h, flags, condv, kin)
    _, nx, b = y.shape
    err = getattr(_build.load(), f"{name}_launch")(
        y.data_ptr(), const.data_ptr(), flags.data_ptr(), condv.data_ptr(),
        kin.data_ptr(), None if hl is None else hl.data_ptr(),
        *(t.data_ptr() for t in outs), nx, b, flags.stride(0),
        flags.stride(1), float(alpha), rh, coef, _build.stream_ptr(y))
    _build.check(err, name)
    _build.launch_counts[name] += 1


def march_rows(y, const, alpha, h, flags, condv, kin) -> torch.Tensor:
    """-F (NX, 7, B) at y (7, NX, B) and yd = (alpha*y + const)/h. CUDA
    tensors launch ``march_rows_kernel``; CPU tensors take
    :func:`march_rows_plain`."""
    _refuse_tracked("march_rows", y, const, h, condv, kin)
    if y.device.type == "cpu":
        return march_rows_plain(y, const, alpha, h, flags, condv, kin)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    _, nx, b = y.shape
    rhs = y.new_empty((nx, NF, b))
    if b > 0:
        _launch("march_rows", (rhs,), y, const, alpha, h, flags, condv, kin)
    return rhs


def march_blocks(y, const, alpha, h, flags, condv, kin):
    """(A, B, C, rhs): the Newton system at y, blocks (NX, 7, 7, B) with
    B + D*alpha/h and the edge slots folded, rhs = -F (NX, 7, B). CUDA
    tensors launch ``march_blocks_kernel``; CPU tensors take
    :func:`march_blocks_plain`."""
    _refuse_tracked("march_blocks", y, const, h, condv, kin)
    if y.device.type == "cpu":
        return march_blocks_plain(y, const, alpha, h, flags, condv, kin)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    _, nx, b = y.shape
    A, B, C = (y.new_empty((nx, NF, NF, b)) for _ in range(3))
    rhs = y.new_empty((nx, NF, b))
    if b > 0:
        _launch("march_blocks", (A, B, C, rhs), y, const, alpha, h, flags,
                condv, kin)
    return A, B, C, rhs


class MarchKernels:
    """The pair bound to one problem's lanes: flags (3, NX, 1), condv
    (5, B), kin (8, B). A Newton call takes it (``takes``) where its
    inputs are float32 and autograd tracks none of them; on the CPU the
    wrappers' plain versions are the PyTorch composition itself."""

    def __init__(self, flags, condv, kin):
        self.flags, self.condv, self.kin = flags, condv.contiguous(), \
            kin.contiguous()

    def takes(self, y, const, h) -> bool:
        ts = (y, const, self.condv, self.kin) + (
            (h,) if torch.is_tensor(h) else ())
        return (torch.is_tensor(const)
                and all(t.dtype == torch.float32 for t in ts)
                and not _tracks(*ts))

    def rows(self, y, alpha, const, h):
        return march_rows(y.contiguous(), const.contiguous(), alpha, h,
                          self.flags, self.condv, self.kin)

    def blocks(self, y, alpha, const, h):
        return march_blocks(y.contiguous(), const.contiguous(), alpha, h,
                            self.flags, self.condv, self.kin)
