"""Hierarchical multi-dataset SMC ensemble (PyTorch port of
``smc_tpu.smc.ensemble``).

D independent tempered-SMC populations, one per dataset, advance together:
every tensor of the ``SMCState`` carries a leading dataset axis, and one
ensemble step is one batched gamma search, one batched resampling and a
batched mutation loop (smc/kernels.py), so each population keeps its own
adaptive gamma schedule, early stop and step ratio while the device sees
(D x N x ...) work. The JAX package gets this from ``jax.vmap`` of its
single-population step; here the axis is written out, and nothing loops
over D.

- Populations whose tempering has finished are frozen whole-state by a
  where-mask: they are still swept (the batched likelihood covers them),
  but their state no longer changes.
- Within a step, a population whose sweeps are done (early stop, or its
  sweep limit) keeps its carry while the others go on.
- The host waits for the device once per ensemble step (is any gamma below
  1?) and once per ensemble sweep after the first (is any population still
  active?); it never reads a per-population value.
- On CUDA the entry points replay the step's pieces as captured CUDA graphs
  (smc/graphs.py), the JAX package's jitted programs; the un-captured
  pieces of :func:`make_ensemble_sweep_fns` stay public and eager.

``loglik_fn(theta (D, N, d), data) -> (log_lik (D, N), aux)`` is batched
over the populations (the JAX package's is per population, under vmap);
``data`` carries the leading D and is passed through untouched. The
ensemble draws from ONE ``Draws`` (rng.py gives the order), where the JAX
package splits a key per dataset.

The JAX package's fused ``while_loop`` program and its sweep-granularity run
are one loop here, with and without polling: :func:`make_ensemble_run` and
:func:`run_ensemble_sweeps` give the same state from the same seed.

On a mesh (``make_ensemble_run(..., mesh=...)``, parallel/mesh.py) the
populations are split over the "data" axis and each population's
particles over the "particles" axis: a process holds (D/n_data, N/S, d).
Per-population reductions run on the particle axis's group only; the
flags the host reads ("any population running", "any population
sweeps") are all-reduced over the whole mesh, so every process takes the
same number of steps and sweeps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from smc_tpu_torch.config import SMCConfig
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import as_draws
from smc_tpu_torch.smc import graphs
from smc_tpu_torch.smc.driver import (StopRequested, _advance, _resample,
                                      _running, _stop_requested, run_step)
from smc_tpu_torch.smc.kernels import (_over, find_gamma,
                                       make_mutation_sweeper,
                                       mutation_result, sweep_limit)
from smc_tpu_torch.smc.state import SMCState
from smc_tpu_torch.utils.metrics import span

# loglik_fn(theta (D, N, d), data) -> (log_lik (D, N), aux)
DataLogLik = Callable[[torch.Tensor, object], Tuple[torch.Tensor, object]]


def _tensor_fields(state: SMCState):
    return [f.name for f in dataclasses.fields(state) if f.name != "key"]


def take_datasets(states: SMCState, idx) -> SMCState:
    """Slice an ensemble state down to the datasets in ``idx`` (a list, an
    index tensor or a boolean mask over the leading axis).

    Every tensor field is gathered, so the result is a valid smaller
    ensemble: each selected population keeps its particles, tempering
    position and controller state, and can be continued with
    ``run_ensemble_sweeps(..., states=take_datasets(...))`` on the same
    slice of the data. ``key`` stays the ensemble's one ``Draws``: the
    continued run draws at the smaller D. Compacting to the populations
    still tempering saves the sweeps that the freeze mask would spend on
    finished ones.
    """
    if states.gamma.dim() != 1:
        raise ValueError(
            "take_datasets expects an ensemble state (leading dataset "
            "axis: per-dataset gamma is (D,), got ndim="
            f"{states.gamma.dim()}); a single-run SMCState would be "
            "silently sliced along the particle axis")
    idx = torch.as_tensor(idx, device=states.gamma.device)
    return states.replace(**{f: getattr(states, f)[idx]
                             for f in _tensor_fields(states)})


def init_ensemble(key, prior: Prior, loglik_fn: DataLogLik, data,
                  n_datasets: int, cfg: SMCConfig, psh=None) -> SMCState:
    """Stacked SMCState with leading dataset axis D: the prior draw of all
    D x N particles and the initial likelihood sweep. ``key`` is an int seed
    or a ``Draws``; the run's device is the prior's. On a mesh (``psh``)
    ``n_datasets`` and ``data`` are this process's populations, and the
    state holds its particle rows of them."""
    dev = prior.device
    draws = as_draws(key, dev)
    n_l = cfg.n_particles
    view = draws
    if psh is not None:
        n_l = cfg.n_particles // psh.particles.size
        view = psh.view(draws, n_l, n_datasets)
    particles = prior.sample(view, (n_datasets, n_l), cfg.dtype)
    log_lik, _ = loglik_fn(particles, data)

    def per_pop(v, dtype=cfg.dtype):
        return torch.full((n_datasets,), v, dtype=dtype, device=dev)
    zi = per_pop(0, torch.int32)
    return SMCState(
        particles=particles, log_lik=log_lik, gamma=per_pop(0.0), key=draws,
        step=zi, ess=per_pop(1.0), max_log_lik=torch.amax(log_lik, dim=-1),
        n_mh=zi, accepted=zi, n_gamma_reductions=zi, mh_ratio=per_pop(1.0),
        total_lik_evals=per_pop(float(cfg.n_particles), torch.float32),
        log_evidence=per_pop(0.0))


def _freeze(done: torch.Tensor, old: SMCState, new: SMCState) -> SMCState:
    """``new`` with the populations flagged in ``done`` (D,) put back to
    their ``old`` state, every tensor field."""
    return new.replace(**{
        f: torch.where(_over(done, getattr(old, f)), getattr(old, f),
                       getattr(new, f)) for f in _tensor_fields(old)})


def make_ensemble_sweep_fns(prior: Prior, loglik_fn: DataLogLik,
                            n_datasets: int, cfg: SMCConfig, psh=None):
    """The pieces of one ensemble step, each bounded by at most one
    mutation sweep of the whole ensemble (D x N likelihood rows).

    Returns ``(einit, prep, mut_init, mut_sweep, finish)``:

    - ``einit(key, data) -> states``: the stacked prior draw and the
      initial likelihood sweep.
    - ``prep(states) -> (key, k_mh, g, parts, lk)``: per-dataset gamma
      search and resampling; no likelihood evaluation. ``key`` and ``k_mh``
      are both the ensemble's ``Draws``.
    - ``mut_init(k_mh, parts, lk, data) -> carry``: the mutation loop's
      carry (no evaluation for rwm).
    - ``mut_sweep(carry, gamma, data, active) -> carry``: ONE sweep of every
      dataset; datasets with ``active[d]`` False keep their old carry.
    - ``finish(states, key, g, carry) -> states``: fold the step in;
      populations already at gamma >= 1 before the step are frozen
      whole-state.

    ``psh``: this process's share of a mesh (module text); ``n_datasets``
    and ``data`` are then its populations.
    """
    built = []          # [data, (init_fn, sweep_fn)] of the last data seen

    def sweeper(data):
        if not built or built[0] is not data:
            def bound(th):
                return loglik_fn(th, data)
            bound.method = getattr(loglik_fn, "method", None)
            built[:] = [data, make_mutation_sweeper(cfg.mutation, bound,
                                                    prior, cfg, psh)]
        return built[1]

    def einit(key, data):
        return init_ensemble(key, prior, loglik_fn, data, n_datasets, cfg,
                             psh)

    def prep(states: SMCState):
        g = find_gamma(states.log_lik, states.gamma, cfg, psh)
        parts, lk = _resample(g, states, cfg, psh)
        return states.key, states.key, g, parts, lk

    def mut_init(k_mh, parts, lk, data):
        if psh is not None:
            k_mh = psh.view(k_mh, parts.shape[-2], parts.shape[0])
        return sweeper(data)[0](k_mh, parts, lk)

    def mut_sweep(c, gamma, data, active):
        return sweeper(data)[1](c, gamma, active)

    def finish(states: SMCState, key, g, c) -> SMCState:
        new = _advance(states.replace(key=key), g, mutation_result(c, psh),
                       cfg, psh)
        return _freeze(states.gamma >= 1.0, states, new)

    return einit, prep, mut_init, mut_sweep, finish


def _step_pieces(fns, cfg: SMCConfig, psh=None) -> graphs.Pieces:
    """:func:`make_ensemble_sweep_fns`'s pieces cut at the seams of
    smc/graphs.py. ``p`` is (gamma search, particles, log_lik, sweep
    limit, frozen): populations at gamma >= 1 before the step are frozen.
    A population sweeps while it is not frozen, its sweeps are not done
    and it has not stopped early; ``more`` is "any population sweeps". On
    a mesh both flags are all-reduced over every process."""
    einit, prep, mut_init, mut_sweep, finish = fns

    def active(c, p):
        return ~c.done & (c.j < p[3]) & ~p[4]

    def anywhere(flag):
        return flag if psh is None else psh.world.any(flag)

    def running(s):
        return anywhere(_running(s, cfg))

    def init(key, data):
        s = einit(key, data)
        return s, running(s)

    def u_prep(s, data):
        _, _, g, parts, lk = prep(s)
        return g, parts, lk, sweep_limit(g.gamma, cfg), s.gamma >= 1.0

    def u_mut_init(s, p, data):
        c = mut_init(s.key, p[1], p[2], data)
        c = mut_sweep(c, p[0].gamma, data, active(c, p))
        return c, anywhere(torch.any(active(c, p)))

    def u_mut_sweep(s, p, c, data):
        c = mut_sweep(c, p[0].gamma, data, active(c, p))
        return c, anywhere(torch.any(active(c, p)))

    def u_finish(s, p, c, data):
        new = finish(s, s.key, p[0], c)
        return new, running(new)

    return graphs.Pieces(init, u_prep, u_mut_init, u_mut_sweep, u_finish)


def _run(programs: graphs.Programs, states: Optional[SMCState], key, data,
         cfg: SMCConfig, n_datasets: int, verbose: bool = False,
         callback=None, stop_file=None, psh=None) -> SMCState:
    """The ensemble loop behind both entry points: from ``states``, or
    from the prior draw with ``key``; the returned state is a copy. The
    stop file is polled before every step and every sweep after a step's
    first; the pre-step states go back, so the caller gets the last
    COMPLETED step either way."""
    with span("smc.run", run=True):
        dev = data.device if states is None else states.particles.device
        pcs, s, data = programs.on(dev, states, data)
        if s is None:
            with span("smc.piece.init"):
                s, running = pcs.init(as_draws(key, dev), data)
        else:
            running = _running(s, cfg)
            if psh is not None:
                running = psh.world.any(running)
        while graphs.read(running, "step"):
            if _stop_requested(stop_file, psh, dev):
                print(f"run_ensemble_sweeps: stop file {stop_file} "
                      f"present — returning at max step "
                      f"{int(s.step.max())}", flush=True)
                break
            try:
                s, running = run_step(pcs, s, data, stop_file, psh)
            except StopRequested:
                print(f"run_ensemble_sweeps: stop file {stop_file} present "
                      f"mid-step — returning last completed step "
                      f"{int(s.step.max())}", flush=True)
                break
            if verbose:
                ng = s.gamma.cpu()
                print(f"ensemble step: {int(s.step.max())}  "
                      f"gamma<1: {int((ng < 1.0).sum())}/{n_datasets}  "
                      f"min gamma: {float(ng.min()):.6f}", flush=True)
            if callback is not None:
                callback(graphs.clone(s))
        return graphs.clone(s)


def run_ensemble_sweeps(key, prior: Prior, loglik_fn: DataLogLik, data,
                        n_datasets: int, cfg: SMCConfig,
                        verbose: bool = False, callback=None,
                        states: Optional[SMCState] = None,
                        stop_file=None) -> SMCState:
    """Host-observed ensemble run. ``callback(states)`` fires after every
    ensemble step with a copy of the state (the checkpointing hook of long
    SBC runs); pass ``states`` to resume. ``stop_file``: as in ``run_smc``,
    polled before every step and every later sweep; when the file appears the
    run returns the last completed ensemble step instead of tempering
    every population to gamma = 1. ``verbose`` prints one line per
    ensemble step. On CUDA the step's pieces are graphs captured for this
    call; the initial draw and sweep (``states`` None) run eagerly."""
    fns = make_ensemble_sweep_fns(prior, loglik_fn, n_datasets, cfg)
    if states is None:
        states = fns[0](key, data)
    programs = graphs.Programs(_step_pieces(fns, cfg)._replace(init=None))
    return _run(programs, states, None, data, cfg, n_datasets,
                verbose=verbose, callback=callback, stop_file=stop_file)


def make_ensemble_run(prior: Prior, loglik_fn: DataLogLik, n_datasets: int,
                      cfg: SMCConfig, mesh=None):
    """``fn(key, data) -> SMCState``: all D populations from the prior draw
    to gamma = 1 (or ``max_steps``) in one call, without printing or
    polling. Build once, call with fresh keys and data: on CUDA the prior
    draw with the initial sweep and each piece of a step are graphs,
    captured at the first call per shape. The returned state is a copy.

    ``mesh``: a 2-D mesh from ``parallel.mesh.make_mesh(n, n_data)``. The
    populations are split over its "data" axis and each population's
    particles over its "particles" axis; every process calls ``fn`` with
    the same key and the whole ``data`` (D, ...), and gets its block
    (D / n_data, N / S, d) of the state (``parallel.mesh.gather_state``
    for the whole). On a gloo group the pieces run eagerly."""
    psh = None
    if mesh is not None:
        from smc_tpu_torch.parallel.mesh import particle_sharding
        psh = particle_sharding(mesh)
        if n_datasets % psh.data.size or cfg.n_particles % \
                psh.particles.size:
            raise ValueError(
                f"{n_datasets} datasets x {cfg.n_particles} particles do "
                f"not divide over the mesh ({psh.data.size} data x "
                f"{psh.particles.size} particle ranks)")
    d_local = n_datasets if psh is None else n_datasets // psh.data.size
    programs = graphs.Programs(_step_pieces(
        make_ensemble_sweep_fns(prior, loglik_fn, d_local, cfg, psh), cfg,
        psh), comm=psh)

    def run(key, data) -> SMCState:
        if psh is not None:
            rows = psh.datasets(n_datasets)
            data = graphs.tree_map(lambda t: t[rows], data)
        return _run(programs, None, key, data, cfg, d_local, psh=psh)

    return run


def run_ensemble_on_device(key, prior: Prior, loglik_fn: DataLogLik, data,
                           n_datasets: int, cfg: SMCConfig,
                           mesh=None) -> SMCState:
    """One-shot convenience over :func:`make_ensemble_run`."""
    return make_ensemble_run(prior, loglik_fn, n_datasets, cfg, mesh)(
        key, data)
