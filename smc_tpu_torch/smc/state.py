"""SMC sampler state (PyTorch port of ``smc_tpu.smc.state``).

One frozen dataclass with the JAX package's 13 fields, so a whole SMC step is
an ``SMCState -> SMCState`` function. Scalars are 0-d tensors on the run's
device, so reading them back is a choice the host loop makes, not a side
effect of the step. ``key`` holds the run's ``Draws`` object (rng.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class SMCState:
    particles: torch.Tensor   # (N, d) current particle positions
    log_lik: torch.Tensor     # (N,)   cached untempered log-likelihoods
    gamma: torch.Tensor       # ()     current tempering exponent in [0, 1]
    key: Any                  # the run's Draws (rng.py)
    step: torch.Tensor        # ()     int32 outer SMC iteration counter
    # --- per-step diagnostics (the metric line of run_smc) ---
    ess: torch.Tensor              # () normalized ESS after the gamma search
    max_log_lik: torch.Tensor      # ()
    n_mh: torch.Tensor             # () int32 MH sweeps used last step
    accepted: torch.Tensor         # () int32 particles accepted >= once
    n_gamma_reductions: torch.Tensor  # () int32 gamma shrink iterations
    mh_ratio: torch.Tensor         # () final proposal step ratio last step
    total_lik_evals: torch.Tensor  # () f32 per-particle likelihood evals
    # Running log marginal-likelihood estimate: the sum over steps of
    # log((1/N) sum_i exp(dgamma_k * ll_i)) (find_gamma's log_z_inc).
    log_evidence: torch.Tensor     # ()

    @property
    def n_particles(self) -> int:
        return self.particles.shape[0]

    @property
    def dim(self) -> int:
        return self.particles.shape[1]

    def replace(self, **kw) -> "SMCState":
        return dataclasses.replace(self, **kw)
