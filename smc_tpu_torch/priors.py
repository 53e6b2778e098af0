"""Vectorized prior (PyTorch port of ``smc_tpu.priors``).

A prior over d parameters is a struct of per-dimension tensors: kind codes
plus (low, high) / (loc, scale). ``sample``, ``log_pdf`` and ``in_support``
broadcast over any particle batch; the per-dimension branch is a
``torch.where``, not Python control flow.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from smc_tpu_torch.config import resolve_device

UNIFORM = 0
NORMAL = 1

_LOG2PI = math.log(2 * math.pi)


@dataclasses.dataclass(frozen=True)
class Prior:
    """Independent per-dimension prior: ``kind[i]`` selects UNIFORM
    (low/high) or NORMAL (loc/scale). Unused slots hold placeholders."""

    kind: torch.Tensor   # (d,) int32
    low: torch.Tensor    # (d,) f32; -inf for normal dims
    high: torch.Tensor   # (d,) f32; +inf for normal dims
    loc: torch.Tensor    # (d,) f32
    scale: torch.Tensor  # (d,) f32

    @property
    def dim(self) -> int:
        return self.kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.low.device

    def to(self, device) -> "Prior":
        dev = resolve_device(device)
        return Prior(*(getattr(self, f.name).to(dev)
                       for f in dataclasses.fields(self)))

    # ---- constructors -------------------------------------------------
    @staticmethod
    def uniform(low, high, device="cuda") -> "Prior":
        dev = resolve_device(device)
        low = torch.as_tensor(low, dtype=torch.float32, device=dev)
        high = torch.as_tensor(high, dtype=torch.float32, device=dev)
        d = low.shape[0]
        return Prior(kind=torch.full((d,), UNIFORM, dtype=torch.int32,
                                     device=dev),
                     low=low, high=high, loc=(low + high) / 2,
                     scale=high - low)

    @staticmethod
    def normal(loc, scale, device="cuda") -> "Prior":
        dev = resolve_device(device)
        loc = torch.as_tensor(loc, dtype=torch.float32, device=dev)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        d = loc.shape[0]
        inf = torch.full((d,), math.inf, dtype=torch.float32, device=dev)
        return Prior(kind=torch.full((d,), NORMAL, dtype=torch.int32,
                                     device=dev),
                     low=-inf, high=inf, loc=loc, scale=scale)

    @staticmethod
    def from_specs(specs: Sequence[dict], device="cuda") -> "Prior":
        """Build from PyMC-style dicts, e.g.
        ``[{"dist": "uniform", "low": 0, "high": 10},
           {"dist": "normal", "mu": 1.0, "sigma": 0.1}]``."""
        dev = resolve_device(device)
        kind, low, high, loc, scale = [], [], [], [], []
        for s in specs:
            if s["dist"] == "uniform":
                lo, hi = float(s["low"]), float(s["high"])
                kind.append(UNIFORM)
                low.append(lo)
                high.append(hi)
                loc.append((lo + hi) / 2)
                scale.append(hi - lo)
            elif s["dist"] == "normal":
                kind.append(NORMAL)
                low.append(-math.inf)
                high.append(math.inf)
                loc.append(float(s.get("mu", s.get("loc", 0.0))))
                scale.append(float(s.get("sigma", s.get("scale", 1.0))))
            else:
                raise ValueError(f"Unknown prior dist: {s['dist']!r}")

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)
        return Prior(kind=torch.tensor(kind, dtype=torch.int32, device=dev),
                     low=f32(low), high=f32(high), loc=f32(loc),
                     scale=f32(scale))

    # ---- kernels -------------------------------------------------------
    def sample(self, gen, n, dtype=torch.float32) -> torch.Tensor:
        """(n, d) prior draws from the ``Draws`` object ``gen``: first the
        uniforms, then the normals (the JAX package's split order). ``n``
        may be a tuple of leading sizes, e.g. (D, N) for an ensemble."""
        shape = ((n,) if isinstance(n, int) else tuple(n)) + (self.dim,)
        u = gen.uniform(shape, dtype)
        z = gen.normal(shape, dtype)
        uni = self.low + u * (self.high - self.low)
        nor = self.loc + z * self.scale
        return torch.where(self.kind == UNIFORM, uni, nor)

    def log_pdf(self, theta: torch.Tensor) -> torch.Tensor:
        """Log prior density summed over dims, (..., d) -> (...,); -inf
        outside a uniform dimension's support."""
        inside = (theta >= self.low) & (theta <= self.high)
        log_uni = torch.where(inside, -torch.log(self.high - self.low),
                              -math.inf)
        z = (theta - self.loc) / self.scale
        log_nor = -0.5 * (z * z + _LOG2PI) - torch.log(self.scale)
        per_dim = torch.where(self.kind == UNIFORM, log_uni, log_nor)
        return torch.sum(per_dim, dim=-1)

    def in_support(self, theta: torch.Tensor) -> torch.Tensor:
        """Boolean support mask, (..., d) -> (...,)."""
        ok = (theta >= self.low) & (theta <= self.high)
        return torch.all(ok | (self.kind != UNIFORM), dim=-1)
