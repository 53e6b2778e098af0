"""Simulation-based calibration (SBC) of the SMC sampler (PyTorch port of
``smc_tpu.smc.sbc``).

SBC (Talts et al. 2018, "Validating Bayesian inference algorithms with
simulation-based calibration"): draw theta_r from the prior, simulate data
y_r from p(y | theta_r), run the sampler on y_r, and compute the rank of
theta_r among L posterior draws, per dimension. If, and only if, the sampler
targets the correct posterior on average over the prior, the R ranks are
uniform on {0, ..., L}.

The hierarchical ensemble (smc/ensemble.py) runs all R replicate posteriors
together, one population each.

Correlated-draw caveat: SMC particles share ancestry, so the L rank draws
are subsampled at random, without replacement, from the N final particles
(L << N), the standard thinning mitigation; residual correlation widens the
rank histogram's noise, it does not bias its mean.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from smc_tpu_torch.config import SMCConfig, resolve_device
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import as_draws
from smc_tpu_torch.smc.ensemble import make_ensemble_run, run_ensemble_sweeps

# simulate_fn(draws, thetas (R, d)) -> data with a leading R: every
# replicate's observations from its prior draw, noise from ``draws``.
SimulateFn = Callable[[object, torch.Tensor], object]


def sbc_ranks(key, prior: Prior, simulate_fn: SimulateFn, loglik_fn,
              n_replicates: int, cfg: SMCConfig, n_rank_draws: int = 127,
              mesh=None, granularity: str = "fused", verbose: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, object]:
    """Run R replicate prior-draw -> simulate -> posterior cycles and return
    (ranks (R, d) int in [0, L], truths (R, d), final ensemble state).

    ``loglik_fn(theta (R, N, d), data)`` is the ensemble's batched
    likelihood; ``simulate_fn`` makes all replicates' data from their prior
    draws. L = ``n_rank_draws`` posterior draws are subsampled without
    replacement from each replicate's N final particles (the first L of an
    argsort of uniforms). ``key`` is an int seed or a ``Draws``; rng.py
    gives the order of the draws.

    ``granularity``: "fused" runs the ensemble through
    ``make_ensemble_run``; "sweep" through ``run_ensemble_sweeps`` (with
    ``verbose``, one line per ensemble step). Both give the same ranks from
    the same seed. On CUDA both replay captured CUDA graphs of the
    ensemble step, captured anew for each call.
    """
    if n_rank_draws >= cfg.n_particles:
        raise ValueError("n_rank_draws must be < n_particles (thinning)")
    if granularity not in ("fused", "sweep"):
        raise ValueError(f"unknown granularity {granularity!r}")
    draws = as_draws(key, prior.device)
    thetas = prior.sample(draws, n_replicates, cfg.dtype)        # (R, d)
    data = simulate_fn(draws, thetas)

    if granularity == "sweep":
        states = run_ensemble_sweeps(draws, prior, loglik_fn, data,
                                     n_replicates, cfg, verbose=verbose)
    else:
        states = make_ensemble_run(prior, loglik_fn, n_replicates, cfg,
                                   mesh=mesh)(draws, data)
    short = int(torch.sum(states.gamma < 1.0))
    if short:
        raise RuntimeError(
            f"SBC: {short}/{n_replicates} replicates did not reach gamma=1 "
            f"within max_steps")

    u = draws.uniform((n_replicates, cfg.n_particles), cfg.dtype)
    idx = torch.argsort(u, dim=1)[:, :n_rank_draws]              # (R, L)
    sub = states.particles.gather(
        1, idx[..., None].expand(-1, -1, states.particles.shape[-1]))
    ranks = torch.sum(sub < thetas[:, None, :], dim=1)
    return ranks.cpu().numpy(), thetas.cpu().numpy(), states


def _bin_expected(n_rank_draws: int, n_bins: int):
    """(edges, non-empty mask, per-bin null probabilities) for binning
    uniform{0..L}.

    Ranks take the L+1 integer values 0..L. When (L+1) is not divisible by
    n_bins, equal-width bins hold unequal numbers of integers, so the null
    expectation must be per bin (a flat R/n_bins would bias the statistic
    and flag valid samplers, e.g. 100 rank draws with 8 bins). Bins
    containing no integer are dropped (their observed count is structurally
    0)."""
    edges = np.linspace(0, n_rank_draws + 1, n_bins + 1)
    per_bin, _ = np.histogram(np.arange(n_rank_draws + 1), bins=edges)
    nz = per_bin > 0
    probs = per_bin[nz] / (n_rank_draws + 1)
    return edges, nz, probs


def rank_chi2(ranks: np.ndarray, n_rank_draws: int, n_bins: int = 8
              ) -> np.ndarray:
    """Per-dimension chi-square statistic of the SBC rank histogram against
    uniform{0..L}, with per-bin expected counts from the number of integers
    each bin covers. Under the null each statistic is chi2(df) with
    df = (number of non-empty bins) - 1 (= n_bins - 1 whenever
    n_bins <= L+1)."""
    ranks = np.asarray(ranks)
    R, d = ranks.shape
    edges, nz, probs = _bin_expected(n_rank_draws, n_bins)
    expected = R * probs
    stats = np.empty(d)
    for j in range(d):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        stats[j] = np.sum((counts[nz] - expected) ** 2 / expected)
    return stats


def rank_chi2_pvalues(ranks: np.ndarray, n_rank_draws: int,
                      n_bins: int = 8) -> np.ndarray:
    """Per-dimension chi-square p-values (requires scipy)."""
    from scipy.stats import chi2
    stats = rank_chi2(ranks, n_rank_draws, n_bins)
    _, nz, _ = _bin_expected(n_rank_draws, n_bins)
    return chi2.sf(stats, df=max(int(nz.sum()) - 1, 1))


# ---------------------------------------------------------------------------
# Canonical SBC problems: one definition of "calibrate the sampler on this
# model family" for scripts and tests.
# ---------------------------------------------------------------------------

def mm_sbc_problem(method: str = "exact", n_datasets: int = 5,
                   device="cuda"):
    """Michaelis-Menten SBC problem.

    Returns ``(prior, simulate_fn, loglik_fn, param_names)`` for
    :func:`sbc_ranks`. The simulator uses the closed-form Lambert-W
    trajectory (the likelihood's own math), so rank deviations are
    attributable to the sampler, not to a forward-model mismatch.
    """
    from smc_tpu_torch.models.michaelis_menten import make_mm_data_loglik
    from smc_tpu_torch.ops.lambertw import lambertw
    dev = resolve_device(device)
    ts = torch.linspace(0.0, 10.0, 40, device=dev)
    s0 = torch.tensor([2.0, 1.0, 4.0, 0.5, 3.0][:n_datasets],
                      dtype=torch.float32, device=dev)
    prior = Prior.uniform([0.5, 0.1, 0.01], [2.0, 1.5, 0.05], device=dev)
    loglik = make_mm_data_loglik(ts, s0, method=method)

    def simulate(draws, thetas):
        vmax, km, sigma = (thetas[:, i, None, None] for i in range(3))
        km_safe = torch.clamp_min(km, 1e-8)                    # (R, 1, 1)
        logz = (torch.log(s0 / km_safe)
                + (s0 - vmax * ts[:, None]) / km_safe)         # (R, T, n_ds)
        S = km_safe * lambertw(torch.exp(torch.clamp(logz, -60.0, 60.0)))
        P_true = (s0 - S).transpose(1, 2)                      # (R, n_ds, T)
        return P_true + sigma * draws.normal(tuple(P_true.shape))

    return prior, simulate, loglik, ("Vmax", "Km", "sigma")


def methanation_sbc_problem(n_conditions: int = 2, nx: int = 11,
                            n_steps: int = 6, growth: float = 1.6,
                            particle_chunk: int = 64, est_idx=(0, 8),
                            reference_prior: bool = False, device="cuda"):
    """Methanation SBC problem (the DAE model family).

    Defaults give the cheap configuration: estimate (Af, sigma) on a coarse
    reactor grid with a narrow uniform prior. The powered configuration
    passes ``est_idx`` = models.methanation.EST_DEFAULT (Af, Eaf, Ar, Ear,
    sigma, putting the Ar/Ear ridge inside the calibration test), ``nx=51``
    and ``reference_prior=True`` (the use_params +- use_params*k bounds of
    ``methanation_prior``). Returns ``(prior, simulate_fn, loglik_fn,
    names)``.

    The flows do not depend on the observations: the likelihood runs one
    pass over the flattened R * N particles and takes the Gaussian term
    against each replicate's own observations.
    """
    from smc_tpu_torch.models.methanation import (MethanationModel,
                                                  methanation_prior)
    dev = resolve_device(device)
    est_idx = tuple(est_idx)
    kw = {}
    if n_steps is not None:
        kw["n_steps"] = n_steps
    if growth is not None:
        kw["growth"] = growth
    model = MethanationModel.default(
        n_conditions=n_conditions, nx=nx, est_idx=est_idx,
        particle_chunk=particle_chunk, noise=False, device=dev, **kw)
    if reference_prior:
        prior = methanation_prior(est_idx, device=dev)
    else:
        if est_idx != (0, 8):
            raise ValueError("narrow default prior only covers (Af, sigma);"
                             " pass reference_prior=True for other subsets")
        prior = Prior.uniform([8.0, 3.0], [20.0, 8.0], device=dev)
    names = tuple(model.param_names)

    def simulate(draws, thetas):
        flows, sigma = model._flows_and_sigma(thetas)        # (R, 5, n_cond)
        return flows + sigma[:, None, None] * draws.normal(
            tuple(flows.shape))

    def loglik(theta, obs):
        d, n = theta.shape[0], theta.shape[1]
        flows, sigma = model._flows_and_sigma(theta.reshape(d * n, -1))
        flows = flows.reshape((d, n) + flows.shape[1:])
        return model._ll_from_flows(flows, sigma.reshape(d, n),
                                    obs[:, None]), flows

    return prior, simulate, loglik, names
