"""Model interface (PyTorch port of ``smc_tpu.models.base``): a prior and a
batched log-likelihood, the SMC "forward pass".

    log_likelihood(theta: (N, d)) -> (log_lik: (N,), predictions or None)

Every model of the port (``michaelis_menten``, ``methanation``,
``synthetic``, ``generic``) has this shape; the particle axis is a batch
axis of the model's own tensor ops, so the likelihood of all particles is
one call on the run's device.
"""
from __future__ import annotations

from typing import Any, Protocol, Tuple

import torch

from smc_tpu_torch.priors import Prior


class Model(Protocol):
    """A Bayesian inverse problem: prior + batched log-likelihood."""

    prior: Prior

    def log_likelihood(self, theta: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """theta (N, d) -> (log_lik (N,), predictions with leading N)."""
        ...

    @property
    def param_names(self) -> Tuple[str, ...]:
        ...
