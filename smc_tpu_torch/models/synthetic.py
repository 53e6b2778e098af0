"""Synthetic targets for the SMC machinery (PyTorch port of
``smc_tpu.models.synthetic``). No ODE: the likelihood is an analytic
log-density, so these exercise the sampler alone.

- banana: a curved, narrowing ridge x1 = x0^2 that the adaptive proposal
  must track as gamma rises;
- Gaussian mixture: well-separated modes, which the tempering schedule must
  keep populated through resampling.

Both are differentiable, so the gradient mutations run on them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.priors import Prior

_LOG2PI = math.log(2 * math.pi)


@dataclasses.dataclass(frozen=True)
class BananaModel:
    """Rosenbrock banana: ll(x) = -(a - x0)^2 / scale0 - b (x1 - x0^2)^2,
    under a wide uniform prior (default Uniform([-6, -10], [6, 40]) on
    ``device``)."""
    a: float = 1.0
    b: float = 20.0
    scale0: float = 1.0
    prior: Optional[Prior] = None
    param_names: Tuple[str, ...] = ("x0", "x1")
    device: str = "cuda"

    def __post_init__(self):
        if self.prior is None:
            object.__setattr__(self, "prior", Prior.uniform(
                [-6.0, -10.0], [6.0, 40.0], device=self.device))

    def log_likelihood(self, theta: torch.Tensor):
        x0, x1 = theta[:, 0], theta[:, 1]
        ll = -(self.a - x0) ** 2 / self.scale0 \
            - self.b * (x1 - x0 ** 2) ** 2
        return ll, None


@dataclasses.dataclass(frozen=True)
class GaussianMixtureModel:
    """K isotropic Gaussians in d dimensions: means (K, d), stds (K,),
    log_weights (K,), tensors on the prior's device."""
    means: torch.Tensor
    stds: torch.Tensor
    log_weights: torch.Tensor
    prior: Prior
    param_names: Tuple[str, ...] = ()

    @staticmethod
    def default(k: int = 4, d: int = 2, sep: float = 8.0, std: float = 0.5,
                device="cuda") -> "GaussianMixtureModel":
        """K equal-weight modes on a circle of radius ``sep`` in the first
        two dimensions, under a uniform prior ``sep + 6 std`` wide."""
        dev = resolve_device(device)
        ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
        means = np.zeros((k, d), np.float32)
        means[:, 0] = sep * np.cos(ang)
        means[:, 1 % d] = sep * np.sin(ang)
        lim = sep + 6 * std
        return GaussianMixtureModel(
            means=torch.as_tensor(means, device=dev),
            stds=torch.full((k,), std, dtype=torch.float32, device=dev),
            log_weights=torch.full((k,), -float(np.log(k)),
                                   dtype=torch.float32, device=dev),
            prior=Prior.uniform([-lim] * d, [lim] * d, device=dev),
            param_names=tuple(f"x{i}" for i in range(d)))

    def log_likelihood(self, theta: torch.Tensor):
        d = theta.shape[1]
        diff = theta[:, None, :] - self.means[None, :, :]      # (N, K, d)
        maha = torch.sum(diff * diff, dim=-1) / self.stds ** 2  # (N, K)
        logp_k = (self.log_weights - 0.5 * maha
                  - d * (0.5 * _LOG2PI + torch.log(self.stds)))
        return torch.logsumexp(logp_k, dim=1), None

    def mode_fractions(self, theta: torch.Tensor) -> torch.Tensor:
        """Fraction of particles nearest each mode (K,), the mode-coverage
        metric; computed on the device without a host read."""
        diff = theta[:, None, :] - self.means[None, :, :]
        nearest = torch.argmin(torch.sum(diff * diff, dim=-1), dim=1)
        k = self.means.shape[0]
        counts = torch.zeros(k, dtype=theta.dtype, device=theta.device)
        counts.scatter_add_(0, nearest, torch.ones_like(theta[:, 0]))
        return counts / theta.shape[0]
