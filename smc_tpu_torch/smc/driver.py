"""SMC driver: init, one step, and the run loops (PyTorch port of
``smc_tpu.smc.driver``).

A step is cut at the JAX package's seams (smc/graphs.py): ``prep`` (gamma
search, resampling), ``mut_init`` with the first sweep, ``mut_sweep`` (one
sweep) and ``finish`` (the fold). On CUDA the run entry points replay each
piece as a captured CUDA graph, captured at the first call per shape and
kept by the function a ``make_*`` call returns, as a jit compile is; on
the CPU the same pieces run eagerly. The host waits for the device once
per step (is gamma below 1?) and once per mutation sweep after the first
(is another due?); nothing else in a step reads a device value.

- :func:`smc_step`: one step from the eager pieces (the un-captured
  reference of every graphed path).
- :func:`make_sweep_step_fns`, :func:`make_smc_step`,
  :func:`make_run_on_device` (state -> state),
  :func:`make_full_run_on_device` (key -> state), :func:`run_smc_on_device`:
  the graphed pieces, step and runs.
- :func:`run_smc`: the observable loop, with the per-step metric line and a
  cooperative stop file (polled per step, or per sweep with
  ``granularity="sweep"``; :class:`StopRequested`).
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
from smc_tpu_torch.smc import graphs
from smc_tpu_torch.smc.kernels import (find_gamma, make_sweep_loop_pieces,
                                       mutation_result, resample_apply,
                                       resample_uniforms, sweep_limit,
                                       sweep_until_done)
from smc_tpu_torch.smc.state import SMCState

logger = logging.getLogger("smc_tpu_torch")

LogLikFn = Callable[[torch.Tensor], Tuple[torch.Tensor, object]]


class StopRequested(Exception):
    """Raised between two sweeps of a step when the cooperative stop file
    appears (``run_smc(granularity="sweep", stop_file=...)``); the run then
    returns the last completed step's state."""


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
        return torch.full((), v, dtype=dtype, device=dev)
    zi = scalar(0, torch.int32)
    return SMCState(
        particles=particles, log_lik=log_lik, gamma=scalar(0.0), key=draws,
        step=zi, ess=scalar(1.0), max_log_lik=torch.max(log_lik),
        n_mh=zi, accepted=zi, n_gamma_reductions=zi, mh_ratio=scalar(1.0),
        total_lik_evals=scalar(float(cfg.n_particles), torch.float32),
        log_evidence=scalar(0.0))


def _resample(g, state: SMCState, cfg: SMCConfig):
    """Weight-proportional selection of (particles, log_lik) by
    ``cfg.resampling``: the step's first draws are the scheme's uniforms
    (smc/kernels.py::resample_uniforms; for an ensemble state, per
    population). Every scheme goes through the merge kernel and one bundle
    gather. ``"ring"`` is the sharded redistribution of residual-systematic
    and is residual-systematic on one device, as in the JAX package."""
    scheme = ("residual_systematic" if cfg.resampling == "ring"
              else cfg.resampling)
    u = resample_uniforms(state.key, scheme, tuple(state.gamma.shape),
                          state.log_lik.shape[-1])
    return resample_apply(u, g.weights, state.particles, state.log_lik,
                          scheme)


def _advance(state: SMCState, g, m, cfg: SMCConfig) -> SMCState:
    """Fold a completed step's gamma search and mutation into the state."""
    return state.replace(
        particles=m.particles, log_lik=m.log_lik, gamma=g.gamma,
        step=state.step + 1, ess=g.ess, max_log_lik=g.max_log_lik,
        n_mh=m.n_steps, accepted=m.accepted.to(torch.int32),
        n_gamma_reductions=g.n_reductions, mh_ratio=m.mh_ratio,
        total_lik_evals=state.total_lik_evals
        + (m.n_steps.to(torch.float32) * cfg.evals_per_sweep
           * state.n_particles),
        log_evidence=state.log_evidence + g.log_z_inc)


def _running(state: SMCState, cfg: SMCConfig) -> torch.Tensor:
    """The loop condition as a device flag (any population, for an
    ensemble)."""
    return torch.any((state.step < cfg.max_steps) & (state.gamma < 1.0))


def _check_granularity(granularity: str) -> None:
    if granularity not in ("step", "sweep", "block"):
        raise ValueError(f"unknown granularity {granularity!r}")
    if granularity == "block":
        raise NotImplementedError(
            "granularity 'block' is not ported yet (ROADMAP Queue 1 item "
            "10); 'step' and 'sweep' run")


def step_pieces(loglik_fn: LogLikFn, prior: Prior, cfg: SMCConfig,
                model=None) -> graphs.Pieces:
    """The eager pieces of one step (signatures in smc/graphs.py); ``init``
    is the prior draw and initial sweep of ``model``, when given. ``p`` is
    (gamma search, particles, log_lik after resampling, sweep limit)."""
    sweep_init, sweep = make_sweep_loop_pieces(cfg.mutation, loglik_fn,
                                               prior, cfg)

    def init(key, data=None):
        s = init_state(key, model, cfg)
        return s, _running(s, cfg)

    def prep(s, data=None):
        g = find_gamma(s.log_lik, s.gamma, cfg)
        parts, lk = _resample(g, s, cfg)
        return g, parts, lk, sweep_limit(g.gamma, cfg)

    def mut_init(s, p, data=None):
        return sweep_init(s.key, p[1], p[2], p[0].gamma, p[3])

    def mut_sweep(s, p, c, data=None):
        return sweep(c, p[0].gamma, p[3])

    def finish(s, p, c, data=None):
        new = _advance(s, p[0], mutation_result(c), cfg)
        return new, _running(new, cfg)

    return graphs.Pieces(None if model is None else init, prep, mut_init,
                         mut_sweep, finish)


def run_step(pieces, s, data=None, stop_file: Optional[str] = None):
    """One step through ``pieces`` (eager or graphed): ``(state,
    running)``. The first sweep needs no read; each later one follows one
    read of the flag the last sweep wrote. With ``stop_file``, polled
    before every later sweep: :class:`StopRequested`."""
    def poll():
        if _stop_requested(stop_file):
            raise StopRequested(stop_file)

    p = pieces.prep(s, data)
    c = sweep_until_done(*pieces.mut_init(s, p, data),
                         lambda c: pieces.mut_sweep(s, p, c, data), poll)
    return pieces.finish(s, p, c, data)


def smc_step(state: SMCState, loglik_fn: LogLikFn, prior: Prior,
             cfg: SMCConfig) -> SMCState:
    """One likelihood-tempered SMC step from the eager pieces: gamma
    search, resampling, mutation. Draws come from ``state.key`` in that
    order."""
    return run_step(step_pieces(loglik_fn, prior, cfg), state)[0]


def make_sweep_step_fns(model, cfg: SMCConfig):
    """The step's four pieces ``(prep, mut_init, mut_sweep, finish)``, each
    one device execution: on CUDA a captured graph (at the first call per
    shape), on the CPU the eager piece. Signatures (smc/graphs.py):

    - ``prep(state) -> p``: gamma search and resampling; zero likelihood
      evaluations;
    - ``mut_init(state, p) -> (carry, more)``: the mutation carry and the
      first sweep; ``more`` is the device flag "another sweep is due";
    - ``mut_sweep(state, p, carry) -> (carry, more)``: one sweep;
    - ``finish(state, p, carry) -> (state, running)``: the fold, and the
      flag "another step is due".

    The JAX package's ``mut_init`` does not sweep, and its host reads
    ``carry.j`` and ``carry.done``; here the first sweep joins ``mut_init``
    and the host reads one flag. On CUDA a returned value is the graphs'
    buffer until the same piece runs again, and ``state`` must be what the
    last ``finish`` returned (or a state to start from, copied in)."""
    stepper = _Stepper(model, cfg)

    def piece(name):
        def call(s, *rest):
            pcs, s, _ = stepper.programs.on(s.particles.device, s, None)
            return getattr(pcs, name)(s, *rest)
        return call
    return tuple(piece(n) for n in ("prep", "mut_init", "mut_sweep",
                                     "finish"))


class _Stepper:
    """The capture cache behind the graphed entry points of one model and
    configuration."""

    def __init__(self, model, cfg: SMCConfig, init: bool = False):
        self.model, self.cfg = model, cfg
        self.programs = graphs.Programs(step_pieces(
            model.log_likelihood, model.prior, cfg,
            model if init else None))

    def step(self, state: SMCState) -> SMCState:
        """One step; the returned state is a copy."""
        pcs, s, data = self.programs.on(state.particles.device, state, None)
        return graphs.clone(run_step(pcs, s, data)[0])

    def run(self, state: Optional[SMCState], key=None) -> SMCState:
        """From ``state``, or from the prior draw with ``key``, to gamma =
        1 (or ``max_steps``); the returned state is a copy."""
        dev = self.model.prior.device
        pcs, s, data = self.programs.on(dev, state, None)
        if s is None:
            s, running = pcs.init(as_draws(key, dev), data)
        else:
            running = _running(s, self.cfg)
        while graphs.read(running):
            s, running = run_step(pcs, s, data)
        return graphs.clone(s)


def make_smc_step(model, cfg: SMCConfig):
    """``state -> state``: one step through the graphed pieces (the JAX
    package's jitted step). The returned state is a copy."""
    return _Stepper(model, cfg).step


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
    """Host-observable SMC run through the graphed pieces, with the
    per-step metric line. ``state`` may be a state to resume from.
    ``stop_file``: when the file appears, the run returns the last
    completed step's state; it is polled before every step, and with
    ``granularity="sweep"`` also between the sweeps of a step. Both
    granularities run the same pieces and give the same state.
    ``"block"`` is not ported. ``callback`` gets a copy of each step's
    state."""
    _check_granularity(granularity)
    if state is None:
        state = init_state(key, model, cfg)
    stepper = _Stepper(model, cfg)
    pcs, s, data = stepper.programs.on(state.particles.device, state, None)
    poll = stop_file if granularity == "sweep" else None
    running = _running(s, cfg)
    t0 = time.perf_counter()
    while graphs.read(running):
        if _stop_requested(stop_file):
            _say(f"run_smc: stop file {stop_file} present — returning at "
                 f"step {int(s.step)} gamma={float(s.gamma):.6f}", warn=True)
            break
        try:
            s, running = run_step(pcs, s, data, poll)
        except StopRequested:
            _say(f"run_smc: stop requested mid-step — returning last "
                 f"completed step {int(s.step)} gamma={float(s.gamma):.6f}",
                 warn=True)
            break
        if verbose:
            _say(f"iteration:{int(s.step)}, nMH:{int(s.n_mh)}, "
                 f"Calculation time:{time.perf_counter() - t0:.3f}, "
                 f"ESS:{float(s.ess):.4f}, "
                 f"Max Likelihood:{float(s.max_log_lik):.4f}, "
                 f"New Gamma:{float(s.gamma):.6f}, "
                 f"Number of Adoption:{int(s.accepted)}")
            if float(s.ess) < cfg.ess_limit:
                print(f"ess reduction warning: ess = {float(s.ess)}")
        if callback is not None:
            callback(graphs.clone(s))
    if float(s.gamma) < 1.0:
        _say(f"tempering didn't complete: last gamma = {float(s.gamma)}",
             warn=True)
    return graphs.clone(s)


def make_run_on_device(model, cfg: SMCConfig):
    """``state -> SMCState`` at gamma = 1 (or ``max_steps``) through the
    graphed pieces. Build once and reuse: the graphs are captured at the
    first call per shape."""
    return _Stepper(model, cfg).run


def make_full_run_on_device(model, cfg: SMCConfig):
    """``key -> SMCState`` at gamma = 1 (or ``max_steps``): the prior draw,
    the initial sweep and every step, each a graph replay on CUDA (the
    prior draw and the initial sweep are one graph of their own). ``key``
    is an int seed or a ``TorchDraws`` (on the CPU any ``Draws``). The
    returned state is a copy: a later call does not change it."""
    stepper = _Stepper(model, cfg, init=True)
    return lambda key: stepper.run(None, key)


def run_smc_on_device(model, cfg: SMCConfig, key,
                      state: Optional[SMCState] = None) -> SMCState:
    """The whole run without per-step output, from ``state`` or from a
    fresh :func:`init_state`. The step that raises gamma to 1 still runs
    its (final-threshold) mutation, then the loop stops. Each call
    captures its graphs anew; for repeated runs keep
    :func:`make_run_on_device`'s function."""
    if state is None:
        state = init_state(key, model, cfg)
    return make_run_on_device(model, cfg)(state)
