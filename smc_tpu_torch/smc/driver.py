"""SMC driver: init, one step, and the run loops (PyTorch port of the
main-path parts of ``smc_tpu.smc.driver``).

PyTorch runs eagerly, so the JAX package's ``lax.while_loop`` over steps is a
Python loop here. The host waits for the device once per step (is gamma
below 1?) and once per mutation sweep (stop early?); nothing else in a step
reads a device value.

- :func:`smc_step`: gamma search -> residual-systematic resampling ->
  adaptive RW-MH mutation.
- :func:`run_smc`: the observable loop, with the per-step metric line and a
  cooperative stop file.
- :func:`make_full_run_on_device` / :func:`run_smc_on_device`: the whole run
  from one call, no printing.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional, Tuple

import torch

from smc_tpu_torch.config import SMCConfig
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import as_draws
from smc_tpu_torch.smc.kernels import (find_gamma, mutate,
                                       residual_systematic_apply)
from smc_tpu_torch.smc.state import SMCState

logger = logging.getLogger("smc_tpu_torch")

LogLikFn = Callable[[torch.Tensor], Tuple[torch.Tensor, object]]


def _stop_requested(stop_file: Optional[str]) -> bool:
    return stop_file is not None and os.path.exists(stop_file)


def init_state(key, model, cfg: SMCConfig,
               particles: Optional[torch.Tensor] = None) -> SMCState:
    """Sample the prior (unless ``particles`` is given) and evaluate the
    initial likelihood sweep. ``key`` is an int seed or a ``Draws``; the
    run's device is the model's."""
    dev = model.prior.device
    draws = as_draws(key, dev)
    if particles is None:
        particles = model.prior.sample(draws, cfg.n_particles, cfg.dtype)
    log_lik, _ = model.log_likelihood(particles)

    def scalar(v, dtype=cfg.dtype):
        return torch.tensor(v, dtype=dtype, device=dev)
    zi = scalar(0, torch.int32)
    return SMCState(
        particles=particles, log_lik=log_lik, gamma=scalar(0.0), key=draws,
        step=zi, ess=scalar(1.0), max_log_lik=torch.max(log_lik),
        n_mh=zi, accepted=zi, n_gamma_reductions=zi, mh_ratio=scalar(1.0),
        total_lik_evals=scalar(float(cfg.n_particles), torch.float32),
        log_evidence=scalar(0.0))


def _resample(g, state: SMCState, cfg: SMCConfig):
    """Residual-systematic selection of (particles, log_lik); the offset v0
    is the step's first draw."""
    if cfg.resampling not in ("residual_systematic", "ring"):
        raise NotImplementedError(
            f"resampling {cfg.resampling!r} is not ported yet; "
            "'residual_systematic' runs")
    v0 = state.key.uniform((), torch.float32)
    return residual_systematic_apply(v0, g.weights, state.particles,
                                     state.log_lik)


def _advance(state: SMCState, g, m, cfg: SMCConfig) -> SMCState:
    """Fold a completed step's gamma search and mutation into the state."""
    return state.replace(
        particles=m.particles, log_lik=m.log_lik, gamma=g.gamma,
        step=state.step + 1, ess=g.ess, max_log_lik=g.max_log_lik,
        n_mh=m.n_steps, accepted=m.accepted.to(torch.int32),
        n_gamma_reductions=g.n_reductions, mh_ratio=m.mh_ratio,
        total_lik_evals=state.total_lik_evals
        + (m.n_steps.to(torch.float32) * cfg.evals_per_sweep
           * state.particles.shape[0]),
        log_evidence=state.log_evidence + g.log_z_inc)


def smc_step(state: SMCState, loglik_fn: LogLikFn, prior: Prior,
             cfg: SMCConfig) -> SMCState:
    """One likelihood-tempered SMC step: gamma search, resampling,
    mutation. Draws come from ``state.key`` in that order."""
    g = find_gamma(state.log_lik, state.gamma, cfg)
    parts, lk = _resample(g, state, cfg)
    m = mutate(state.key, parts, lk, g.gamma, loglik_fn, prior, cfg)
    return _advance(state, g, m, cfg)


def _running(state: SMCState, cfg: SMCConfig) -> bool:
    """The loop condition, read from the device once per step."""
    return bool(((state.step < cfg.max_steps) & (state.gamma < 1.0)).item())


def _say(msg: str, warn: bool = False) -> None:
    if logger.handlers:
        (logger.warning if warn else logger.info)(msg)
    else:
        print(msg)


def run_smc(model, cfg: SMCConfig, key,
            callback: Optional[Callable[[SMCState], None]] = None,
            state: Optional[SMCState] = None, verbose: bool = True,
            granularity: str = "step",
            stop_file: Optional[str] = None) -> SMCState:
    """Host-observable SMC run: one step per loop, with the per-step metric
    line. ``state`` may be a state to resume from. ``stop_file``: when the
    file appears, the run returns the last completed step's state.
    Only ``granularity="step"`` is ported."""
    if granularity != "step":
        raise NotImplementedError(
            f"granularity {granularity!r} is not ported yet; 'step' runs")
    if state is None:
        state = init_state(key, model, cfg)
    t0 = time.perf_counter()
    while _running(state, cfg):
        if _stop_requested(stop_file):
            _say(f"run_smc: stop file {stop_file} present — returning at "
                 f"step {int(state.step)} gamma={float(state.gamma):.6f}",
                 warn=True)
            return state
        state = smc_step(state, model.log_likelihood, model.prior, cfg)
        if verbose:
            _say(f"iteration:{int(state.step)}, nMH:{int(state.n_mh)}, "
                 f"Calculation time:{time.perf_counter() - t0:.3f}, "
                 f"ESS:{float(state.ess):.4f}, "
                 f"Max Likelihood:{float(state.max_log_lik):.4f}, "
                 f"New Gamma:{float(state.gamma):.6f}, "
                 f"Number of Adoption:{int(state.accepted)}")
            if float(state.ess) < cfg.ess_limit:
                print(f"ess reduction warning: ess = {float(state.ess)}")
        if callback is not None:
            callback(state)
    if float(state.gamma) < 1.0:
        _say(f"tempering didn't complete: last gamma = {float(state.gamma)}",
             warn=True)
    return state


def _run_to_end(state: SMCState, model, cfg: SMCConfig) -> SMCState:
    while _running(state, cfg):
        state = smc_step(state, model.log_likelihood, model.prior, cfg)
    return state


def make_full_run_on_device(model, cfg: SMCConfig):
    """``key -> SMCState`` at gamma = 1 (or ``max_steps``): the prior draw,
    the initial sweep and every step from one call. ``key`` is an int seed
    or a ``Draws``."""
    def _full(key) -> SMCState:
        return _run_to_end(init_state(key, model, cfg), model, cfg)
    return _full


def run_smc_on_device(model, cfg: SMCConfig, key,
                      state: Optional[SMCState] = None) -> SMCState:
    """The whole run without per-step output, from ``state`` or from a
    fresh :func:`init_state`. The step that raises gamma to 1 still runs
    its (final-threshold) mutation, then the loop stops."""
    if state is None:
        state = init_state(key, model, cfg)
    return _run_to_end(state, model, cfg)
