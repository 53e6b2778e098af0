"""SMC hyperparameter configuration (PyTorch port of ``smc_tpu.config``).

A frozen dataclass with the same fields, defaults and checks as the JAX
package's ``SMCConfig``, so one configuration means the same sampler in both
packages. ``dtype`` is a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    """Hyperparameters of the likelihood-tempered SMC sampler.

    - ``n_particles``: particle count N.
    - ``ess_limit``: ESS/N threshold the tempering search must exceed.
    - ``d_gamma_max``: max tempering increment per step.
    - ``gamma_reduction_rate`` / ``gamma_reduction_iters``: the geometric
      shrink ladder of candidate increments (K = iters + 1 candidates).
    - ``mh_steps`` / ``mh_steps_final``: mutation sweeps while gamma < 1 and
      at gamma == 1.
    - ``mh_cov_diag`` / ``mh_cov_offdiag``: elementwise proposal-covariance
      weights.
    - ``accept_threshold`` / ``accept_threshold_final``: early stop once the
      accepted-at-least-once fraction exceeds this (gamma < 1 / == 1).
    - ``accept_threshold_min`` / ``mh_ratio_decay``: halve the proposal step
      ratio while the accepted fraction is below the floor.
    - ``max_steps``: max outer SMC steps.
    """

    n_particles: int = 1000
    ess_limit: float = 0.5
    d_gamma_max: float = 1.0
    gamma_reduction_rate: float = 0.7
    gamma_reduction_iters: int = 80
    mh_steps: int = 5
    mh_steps_final: int = 20
    mh_cov_diag: float = 0.5
    mh_cov_offdiag: float = 0.5
    accept_threshold: float = 0.5
    accept_threshold_final: float = 0.7
    accept_threshold_min: float = 0.1
    mh_ratio_decay: float = 0.5
    max_steps: int = 50
    # Only "residual_systematic" runs in this package so far; the other
    # schemes are accepted for parity of the configuration surface.
    resampling: str = "residual_systematic"
    # Only "rwm" runs in this package so far; "mala"/"hmc" raise in mutate.
    mutation: str = "rwm"
    hmc_leapfrog: int = 5
    block_particles: Optional[int] = None
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.n_particles < 2:
            raise ValueError("n_particles must be >= 2")
        if not (0.0 < self.ess_limit <= 1.0):
            raise ValueError("ess_limit must be in (0, 1]")
        if not (0.0 < self.gamma_reduction_rate < 1.0):
            raise ValueError("gamma_reduction_rate must be in (0, 1)")
        if self.mh_steps < 1 or self.mh_steps_final < 1:
            raise ValueError("mh_steps / mh_steps_final must be >= 1")
        if self.resampling not in ("residual_systematic", "ring",
                                   "systematic", "stratified",
                                   "multinomial"):
            raise ValueError(f"unknown resampling {self.resampling!r}")
        if self.mutation not in ("rwm", "mala", "hmc"):
            raise ValueError(f"unknown mutation {self.mutation!r}")
        if self.hmc_leapfrog < 1:
            raise ValueError("hmc_leapfrog must be >= 1")
        if self.block_particles is not None:
            if (self.block_particles < 1
                    or self.n_particles % self.block_particles):
                raise ValueError("block_particles must divide n_particles")
        if not (isinstance(self.dtype, torch.dtype)
                and self.dtype.is_floating_point):
            raise ValueError(
                f"dtype must be a floating torch dtype, got {self.dtype!r}")

    @property
    def evals_per_sweep(self) -> int:
        """Likelihood evaluations per mutation sweep (cost accounting)."""
        return self.hmc_leapfrog if self.mutation == "hmc" else 1

    def cov_weight(self, d: int, device=None) -> torch.Tensor:
        """(d, d) proposal-covariance weights: ``mh_cov_offdiag`` off the
        diagonal, ``mh_cov_diag`` on it."""
        w = torch.full((d, d), self.mh_cov_offdiag, dtype=self.dtype,
                       device=device)
        w.fill_diagonal_(self.mh_cov_diag)
        return w

    def replace(self, **kw) -> "SMCConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Raises when CUDA is asked for and absent (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "smc_tpu_torch runs on an NVIDIA GPU by default and CUDA is not "
            "available here; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev
