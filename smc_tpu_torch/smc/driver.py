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
- :func:`make_block_step_fns`: the block-granularity pieces (each sweep's
  core in slabs of ``cfg.block_particles`` rows), graphed likewise.
- :func:`run_smc`: the observable loop, with the per-step metric line and a
  cooperative stop file (polled per step, per sweep with
  ``granularity="sweep"``, per slab with ``"block"``;
  :class:`StopRequested`).

Every entry point takes ``psharding`` (``parallel.mesh.particle_sharding``
of a mesh): then the state holds this process's rows of the particles,
the pieces complete each reduction with a collective
(``smc/kernels.py``), resample through ``parallel/resample_shmap.py``, and
draw through the rank's view of the shared generator. On NCCL the
collectives are captured in the graphs; on gloo, which cannot be
captured, the pieces run eagerly on CUDA too, and the run says so when it
starts. The stop file is agreed across the ranks before it is obeyed.
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
from smc_tpu_torch.smc.kernels import (find_gamma, make_mutation_parts,
                                       make_sweep_loop_pieces,
                                       mutation_result, resample_apply,
                                       resample_uniforms, sweep_limit,
                                       sweep_until_done)
from smc_tpu_torch.smc.state import SMCState

logger = logging.getLogger("smc_tpu_torch")

LogLikFn = Callable[[torch.Tensor], Tuple[torch.Tensor, object]]


class StopRequested(Exception):
    """Raised between two sweeps of a step (``run_smc(granularity=
    "sweep", stop_file=...)``), or between two slabs of a sweep
    (``granularity="block"``), when the cooperative stop file appears; the
    run then returns the last completed step's state."""


def _stop_requested(stop_file: Optional[str], psh=None,
                    device=None) -> bool:
    seen = stop_file is not None and os.path.exists(stop_file)
    if psh is None or stop_file is None:
        return seen
    return psh.world.agree(seen, device)


def _local_n(cfg: SMCConfig, psh) -> int:
    """The particles this process holds."""
    return cfg.n_particles if psh is None else (
        cfg.n_particles // psh.particles.size)


def init_state(key, model, cfg: SMCConfig,
               particles: Optional[torch.Tensor] = None,
               psharding=None) -> SMCState:
    """Sample the prior (unless ``particles`` is given) and evaluate the
    initial likelihood sweep, in slabs of ``cfg.block_particles`` rows when
    that is set and smaller than N (the likelihood is row-independent, so
    the result is the unsplit sweep's). ``key`` is an int seed or a
    ``Draws``; the run's device is the model's. With ``psharding`` the
    state holds this process's rows (the global draw's, ``particles`` being
    them when given) and the slabs are slabs of those rows."""
    dev = model.prior.device
    draws = as_draws(key, dev)
    if particles is None:
        n_l = _local_n(cfg, psharding)
        view = draws if psharding is None else psharding.view(draws, n_l)
        particles = model.prior.sample(view, n_l, cfg.dtype)
    n, b = particles.shape[0], cfg.block_particles
    if b and b < n:
        log_lik = torch.cat([model.log_likelihood(particles[lo:lo + b])[0]
                             for lo in range(0, n, b)])
    else:
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


def _resample(g, state: SMCState, cfg: SMCConfig, psh=None):
    """Weight-proportional selection of (particles, log_lik) by
    ``cfg.resampling``: the step's first draws are the scheme's uniforms
    (smc/kernels.py::resample_uniforms; for an ensemble state, per
    population). Every scheme goes through the merge kernel and one bundle
    gather. ``"ring"`` is the sharded redistribution of residual-systematic
    and is residual-systematic on one device, as in the JAX package.
    Sharded (``psh``): one population's ``"ring"`` runs
    ``resample_sharded_ring``, everything else the all-gather form
    (``parallel/resample_shmap.py``); the per-slot uniforms of stratified
    and multinomial are drawn whole, at the global N, on every rank."""
    scheme = ("residual_systematic" if cfg.resampling == "ring"
              else cfg.resampling)
    pops = tuple(state.gamma.shape)
    n_l = state.log_lik.shape[-1]
    if psh is None:
        u = resample_uniforms(state.key, scheme, pops, n_l)
        return resample_apply(u, g.weights, state.particles, state.log_lik,
                              scheme)
    from smc_tpu_torch.parallel.resample_shmap import (
        resample_apply_sharded, resample_sharded_ring)
    draws = psh.view(state.key, n_l, pops[0] if pops else None)
    u = resample_uniforms(draws, scheme, pops, psh.n_global(n_l))
    if cfg.resampling == "ring" and not pops:
        return resample_sharded_ring(u, g.weights, state.particles,
                                     state.log_lik, psh)
    return resample_apply_sharded(u, g.weights, state.particles,
                                  state.log_lik, scheme, psh)


def _advance(state: SMCState, g, m, cfg: SMCConfig, psh=None) -> SMCState:
    """Fold a completed step's gamma search and mutation into the state
    (the likelihood evaluations counted over all N particles)."""
    n = state.n_particles if psh is None else psh.n_global(state.n_particles)
    return state.replace(
        particles=m.particles, log_lik=m.log_lik, gamma=g.gamma,
        step=state.step + 1, ess=g.ess, max_log_lik=g.max_log_lik,
        n_mh=m.n_steps, accepted=m.accepted.to(torch.int32),
        n_gamma_reductions=g.n_reductions, mh_ratio=m.mh_ratio,
        total_lik_evals=state.total_lik_evals
        + (m.n_steps.to(torch.float32) * cfg.evals_per_sweep * n),
        log_evidence=state.log_evidence + g.log_z_inc)


def _running(state: SMCState, cfg: SMCConfig) -> torch.Tensor:
    """The loop condition as a device flag (any population, for an
    ensemble)."""
    return torch.any((state.step < cfg.max_steps) & (state.gamma < 1.0))


def _check_granularity(granularity: str) -> None:
    if granularity not in ("step", "sweep", "block"):
        raise ValueError(f"unknown granularity {granularity!r}")


def _prep_and_finish(cfg: SMCConfig, psh=None):
    """The ``prep`` and ``finish`` pieces every granularity shares. ``p``
    is (gamma search, particles, log_lik after resampling, sweep limit)."""
    def prep(s, data=None):
        g = find_gamma(s.log_lik, s.gamma, cfg, psh)
        parts, lk = _resample(g, s, cfg, psh)
        return g, parts, lk, sweep_limit(g.gamma, cfg)

    def finish(s, p, c, data=None):
        new = _advance(s, p[0], mutation_result(c, psh), cfg, psh)
        return new, _running(new, cfg)

    return prep, finish


def _draws_of(s: SMCState, psh):
    """The state's draws as this process takes them (its rows' view when
    sharded)."""
    return s.key if psh is None else psh.view(s.key, s.n_particles)


def step_pieces(loglik_fn: LogLikFn, prior: Prior, cfg: SMCConfig,
                model=None, psh=None) -> graphs.Pieces:
    """The eager pieces of one step (signatures in smc/graphs.py); ``init``
    is the prior draw and initial sweep of ``model``, when given."""
    sweep_init, sweep = make_sweep_loop_pieces(cfg.mutation, loglik_fn,
                                               prior, cfg, psh)
    prep, finish = _prep_and_finish(cfg, psh)

    def init(key, data=None):
        s = init_state(key, model, cfg, psharding=psh)
        return s, _running(s, cfg)

    def mut_init(s, p, data=None):
        return sweep_init(_draws_of(s, psh), p[1], p[2], p[0].gamma, p[3])

    def mut_sweep(s, p, c, data=None):
        return sweep(c, p[0].gamma, p[3])

    return graphs.Pieces(None if model is None else init, prep, mut_init,
                         mut_sweep, finish)


def block_pieces(loglik_fn: LogLikFn, prior: Prior,
                 cfg: SMCConfig, psh=None) -> graphs.BlockPieces:
    """The eager pieces of one block-granularity step (signatures in
    smc/graphs.py): a sweep is ``draw`` (the covariance factors and the
    full-N draws), ``core`` once per slab of ``cfg.block_particles`` rows
    (propose, evaluate, accept), and ``admin`` (the controller, over the
    slabs' outputs concatenated); the gradient kinds' initial gradients
    come slab by slab from ``grad``. The core is row-independent, so the
    slabs give the full-N core's rows (sharded: slabs of this process's
    rows)."""
    init_fn, draw_fn, core_fn, admin_fn, grad_fn = make_mutation_parts(
        cfg.mutation, loglik_fn, prior, cfg, psh)
    n_l = _local_n(cfg, psh)
    b = cfg.block_particles or n_l
    prep, finish = _prep_and_finish(cfg, psh)

    def grad(s, p, lo):
        return grad_fn(p[1][lo:lo + b])

    def mut_init(s, p, grads):
        return init_fn(_draws_of(s, psh), p[1], p[2],
                       None if grads is None else torch.cat(grads))

    def draw(s, c):
        return draw_fn(c)

    def core(s, p, c, a, lo):
        rows = slice(lo, lo + b)
        return core_fn(c.particles[rows], c.log_lik[rows],
                       c.log_prior[rows],
                       c.grad if c.grad.dim() == 0 else c.grad[rows],
                       c.mh_ratio, a[1], tuple(x[rows] for x in a[2]),
                       p[0].gamma)

    def admin(s, p, c, a, outs):
        cols = list(zip(*outs))
        g1 = cols[3][0] if cols[3][0].dim() == 0 else torch.cat(cols[3])
        c = admin_fn(c, a[0], torch.cat(cols[0]), torch.cat(cols[1]),
                     torch.cat(cols[2]), g1, torch.cat(cols[4]), p[0].gamma)
        return c, (c.j < p[3]) & ~c.done

    return graphs.BlockPieces(
        prep, None if grad_fn is None else grad, mut_init, draw, core, admin,
        finish, tuple(range(0, n_l, b)))


def run_step(pieces, s, data=None, stop_file: Optional[str] = None,
             psh=None):
    """One step through ``pieces`` (eager or graphed): ``(state,
    running)``. The first sweep needs no read; each later one follows one
    read of the flag the last sweep wrote. With ``stop_file``, polled
    before every later sweep: :class:`StopRequested`."""
    def poll():
        if _stop_requested(stop_file, psh, s.particles.device):
            raise StopRequested(stop_file)

    p = pieces.prep(s, data)
    c = sweep_until_done(*pieces.mut_init(s, p, data),
                         lambda c: pieces.mut_sweep(s, p, c, data), poll)
    return pieces.finish(s, p, c, data)


def smc_step(state: SMCState, loglik_fn: LogLikFn, prior: Prior,
             cfg: SMCConfig, psharding=None) -> SMCState:
    """One likelihood-tempered SMC step from the eager pieces: gamma
    search, resampling, mutation. Draws come from ``state.key`` in that
    order. ``psharding``: the state is this process's rows."""
    return run_step(step_pieces(loglik_fn, prior, cfg, psh=psharding),
                    state)[0]


def make_sweep_step_fns(model, cfg: SMCConfig, psharding=None):
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
    last ``finish`` returned (or a state to start from, copied in).
    ``psharding``: the state is this process's rows (module text)."""
    return _bound_pieces(_Stepper(model, cfg, psharding=psharding),
                         ("prep", "mut_init", "mut_sweep", "finish"))


def _bound_pieces(stepper, names):
    """Each named piece of ``stepper``'s programs as a function of a state
    (then the piece's other arguments), run on the state's device; None
    for a piece the programs do not have."""
    def piece(name):
        def call(s, *rest):
            pcs, s, _ = stepper.programs.on(s.particles.device, s, None)
            return getattr(pcs, name)(s, *rest)
        return call
    return tuple(None if getattr(stepper.programs.pieces, n) is None
                 else piece(n) for n in names)


def make_block_step_fns(model, cfg: SMCConfig, psharding=None):
    """The block-granularity step's pieces ``(prep, mut_init, draw, core,
    admin, grad_fn, finish)``, each one device execution: on CUDA a
    captured graph (one per slab for ``core`` and ``grad_fn``, over views
    of the full-N buffers), on the CPU the eager piece. Signatures
    (smc/graphs.py, ``BlockPieces``):

    - ``prep(state) -> p``: gamma search and resampling;
    - ``grad_fn(state, p, lo)``: the initial likelihood gradients of the
      slab that starts at row ``lo`` (None for "rwm");
    - ``mut_init(state, p, grads) -> carry``: the mutation carry, with the
      slabs' gradients (None for "rwm"); no sweep;
    - ``draw(state, carry) -> a``: a sweep's covariance factors and its
      full-N draws;
    - ``core(state, p, carry, a, lo)``: propose, evaluate and accept the
      ``cfg.block_particles`` rows from ``lo``;
    - ``admin(state, p, carry, a, outs) -> (carry, more)``: the controller
      over the slabs' outputs, and the flag "another sweep is due";
    - ``finish(state, p, carry) -> (state, running)``.

    As for :func:`make_sweep_step_fns`, a returned value is the graphs'
    buffer until the same piece runs again. The JAX package's block
    pieces take the state's parts as arguments (``mut_init(k_mh, parts,
    lk, g0)``, ``core(parts, lk1, ...)``); here each takes the state, the
    step's ``p`` and the carry, as the graphs read them. ``psharding``:
    the state is this process's rows and the slabs are slabs of them."""
    return _bound_pieces(_Stepper(model, cfg, block=True,
                                  psharding=psharding),
                         ("prep", "mut_init", "draw", "core", "admin",
                          "grad", "finish"))


def _run_step_by_blocks(state: SMCState, cfg: SMCConfig, fns,
                        stop_file: Optional[str] = None, psh=None):
    """One step through :func:`make_block_step_fns`'s pieces: ``(state,
    running)``. The first sweep needs no read; each later one follows one
    read of the flag the last ``admin`` wrote. With ``stop_file``, polled
    before every slab's core: :class:`StopRequested`."""
    prep, mut_init, draw, core, admin, grad_fn, finish = fns
    starts = range(0, state.n_particles,
                   cfg.block_particles or state.n_particles)
    p = prep(state)
    grads = (None if grad_fn is None
             else [grad_fn(state, p, lo) for lo in starts])
    c = mut_init(state, p, grads)
    more = None
    while more is None or graphs.read(more):
        a = draw(state, c)
        outs = []
        for lo in starts:
            if _stop_requested(stop_file, psh, state.particles.device):
                raise StopRequested(stop_file)
            outs.append(core(state, p, c, a, lo))
        c, more = admin(state, p, c, a, outs)
    return finish(state, p, c)


def _comm_of(model, psh):
    """The collectives a run's graphs hold: the run's, or those of the
    model's own lane mesh (methanation ``lane_mesh``)."""
    if psh is not None:
        return psh
    lane = getattr(model, "lane_mesh", None)
    if lane is None:
        return None
    from smc_tpu_torch.parallel.mesh import particle_sharding
    return particle_sharding(lane)


class _Stepper:
    """The capture cache behind the graphed entry points of one model and
    configuration."""

    def __init__(self, model, cfg: SMCConfig, init: bool = False,
                 block: bool = False, psharding=None):
        self.model, self.cfg = model, cfg
        comm = _comm_of(model, psharding)
        self.programs = graphs.Programs(
            block_pieces(model.log_likelihood, model.prior, cfg, psharding)
            if block
            else step_pieces(model.log_likelihood, model.prior, cfg,
                             model if init else None, psharding),
            comm=comm)
        if (comm is not None and not comm.capturable
                and model.prior.device.type == "cuda"
                and comm.world.rank == 0):
            _say("gloo process group: collectives cannot be captured in "
                 "CUDA graphs; the step's pieces run eagerly on the card")

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


def make_smc_step(model, cfg: SMCConfig, psharding=None):
    """``state -> state``: one step through the graphed pieces (the JAX
    package's jitted step). The returned state is a copy. ``psharding``:
    the state is this process's rows (module text)."""
    return _Stepper(model, cfg, psharding=psharding).step


def _say(msg: str, warn: bool = False) -> None:
    if logger.handlers:
        (logger.warning if warn else logger.info)(msg)
    else:
        print(msg)


def run_smc(model, cfg: SMCConfig, key,
            callback: Optional[Callable[[SMCState], None]] = None,
            state: Optional[SMCState] = None, verbose: bool = True,
            granularity: str = "step",
            stop_file: Optional[str] = None,
            psharding=None) -> SMCState:
    """Host-observable SMC run through the graphed pieces, with the
    per-step metric line. ``state`` may be a state to resume from.
    ``stop_file``: when the file appears, the run returns the last
    completed step's state; it is polled before every step, with
    ``granularity="sweep"`` also between the sweeps of a step, and with
    ``"block"`` before every slab of a sweep
    (:func:`make_block_step_fns`: each sweep's likelihood work in
    ``n_particles / cfg.block_particles`` executions). ``"step"`` and
    ``"sweep"`` run the same pieces and give the same state; ``"block"``
    runs the same core on slabs of rows. ``callback`` gets a copy of each
    step's state.

    ``psharding``: one run over the processes of a mesh (module text);
    ``state`` is then this process's rows (``init_state(...,
    psharding=...)``), every process runs this function, and only the
    first one prints. On a gloo group the pieces run eagerly (it says so).
    """
    _check_granularity(granularity)
    psh = psharding
    if state is None:
        state = init_state(key, model, cfg, psharding=psh)
    if granularity == "block":
        fns = make_block_step_fns(model, cfg, psh)
        s = state

        def step(s):
            return _run_step_by_blocks(s, cfg, fns, stop_file, psh)
    else:
        stepper = _Stepper(model, cfg, psharding=psh)
        pcs, s, data = stepper.programs.on(state.particles.device, state,
                                           None)
        poll = stop_file if granularity == "sweep" else None

        def step(s):
            return run_step(pcs, s, data, poll, psh)
    if psh is not None and psh.world.rank != 0:
        verbose = False
    dev = state.particles.device
    running = _running(s, cfg)
    t0 = time.perf_counter()
    while graphs.read(running):
        if _stop_requested(stop_file, psh, dev):
            _say(f"run_smc: stop file {stop_file} present — returning at "
                 f"step {int(s.step)} gamma={float(s.gamma):.6f}", warn=True)
            break
        try:
            s, running = step(s)
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


def make_run_on_device(model, cfg: SMCConfig, psharding=None):
    """``state -> SMCState`` at gamma = 1 (or ``max_steps``) through the
    graphed pieces. Build once and reuse: the graphs are captured at the
    first call per shape. ``psharding``: the state is this process's rows
    (module text)."""
    return _Stepper(model, cfg, psharding=psharding).run


def make_full_run_on_device(model, cfg: SMCConfig, psharding=None):
    """``key -> SMCState`` at gamma = 1 (or ``max_steps``): the prior draw,
    the initial sweep and every step, each a graph replay on CUDA (the
    prior draw and the initial sweep are one graph of their own). ``key``
    is an int seed or a ``TorchDraws`` (on the CPU any ``Draws``). The
    returned state is a copy: a later call does not change it.
    ``psharding``: every process calls it with the same key and gets its
    rows of the run (module text)."""
    stepper = _Stepper(model, cfg, init=True, psharding=psharding)
    return lambda key: stepper.run(None, key)


def run_smc_on_device(model, cfg: SMCConfig, key,
                      state: Optional[SMCState] = None,
                      psharding=None) -> SMCState:
    """The whole run without per-step output, from ``state`` or from a
    fresh :func:`init_state`. The step that raises gamma to 1 still runs
    its (final-threshold) mutation, then the loop stops. Each call
    captures its graphs anew; for repeated runs keep
    :func:`make_run_on_device`'s function."""
    if state is None:
        state = init_state(key, model, cfg, psharding=psharding)
    return make_run_on_device(model, cfg, psharding)(state)
