"""High-level run orchestration: SMC + artifacts (PyTorch port of
``smc_tpu.runner``).

The reference's three ~90%-duplicated entry scripts expressed once: run a
model to gamma = 1 while writing the reference's full artifact set (per-step
particle CSVs and histogram-progress plots, parity plots, checkpoints,
posterior CSV + pairplot + prior/posterior comparison, and the per-step
console metric line), the same tree the JAX package writes.

On CUDA ``run_smc`` replays captured graphs and hands the callback a copy
of each step's state, so the manager's host reads happen between replays
and change no bit of the run.

With a mesh (``run_with_artifacts(mesh=...)``) every process runs its rows
of the run; each step's state is gathered (a collective every process
joins) and only the primary process writes the artifacts, the files a
one-device run writes.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import tempfile
import time
import traceback
from typing import Optional, Sequence

import torch

from smc_tpu_torch.config import SMCConfig
from smc_tpu_torch.io.checkpoint import (load_state, save_state,
                                         save_state_async, save_state_chunked)
from smc_tpu_torch.io.csvio import save_particles_csv, save_posterior_csv
from smc_tpu_torch.io.rundir import RunDir
from smc_tpu_torch.parallel.multihost import is_primary_host
from smc_tpu_torch.runtime import AsyncCheckpointer
from smc_tpu_torch.smc.driver import init_state, run_smc
from smc_tpu_torch.utils.metrics import MetricsLogger
from smc_tpu_torch.utils.resilient import run_resilient
from smc_tpu_torch.viz import plots


def _host(particles: torch.Tensor):
    return particles.detach().cpu().numpy()


class RunManager:
    """Callback bundle writing the reference's artifact tree per SMC step.

    ``seconds`` holds the wall seconds spent on each kind of artifact
    ("metrics", "csv", "checkpoint", "histogram", "parity") over the
    run."""

    def __init__(self, rundir: RunDir, model, cfg: SMCConfig,
                 true_values: Optional[Sequence[float]] = None,
                 plots_enabled: bool = True,
                 checkpoint_every: int = 1,
                 parity_every: int = 1,
                 parity_subsample: int = 64,
                 async_io: bool = True,
                 checkpoint_format: str = "auto"):
        self.rd = rundir
        self.model = model
        self.cfg = cfg
        self.true_values = true_values
        self.plots_enabled = plots_enabled
        self.checkpoint_every = max(1, checkpoint_every)
        # Per-step parity plots (the reference draws them DURING the run);
        # predicted outputs come from one small extra likelihood call on a
        # particle subsample.
        self.parity_every = max(1, parity_every)
        self.parity_subsample = parity_subsample
        self._pred_model = None
        self.prior_particles = None
        # "auto": native async .smck if available else .npz; "npz"/"smck"
        # force those; "smcd" streams row slabs to a memory-mapped
        # per-field directory (io/checkpoint.save_state_chunked).
        if checkpoint_format not in ("auto", "npz", "smck", "smcd"):
            raise ValueError(
                f"unknown checkpoint_format {checkpoint_format!r}")
        self.checkpoint_format = checkpoint_format
        self._ckpt = None
        if async_io and checkpoint_format in ("auto", "smck"):
            ck = AsyncCheckpointer()
            self._ckpt = ck if ck.is_native else None
        self.metrics = MetricsLogger(rundir.file("metrics.jsonl"))
        self.seconds = collections.defaultdict(float)

    @contextlib.contextmanager
    def _clock(self, kind: str):
        t0 = time.perf_counter()
        yield
        self.seconds[kind] += time.perf_counter() - t0

    def _save_ckpt(self, state, name: str):
        if self.checkpoint_format == "smcd":
            save_state_chunked(self.rd.file("checkpoints", name + ".smcd"),
                               state)
        elif self._ckpt is not None:
            save_state_async(self._ckpt,
                             self.rd.file("checkpoints", name + ".smck"),
                             state)
        else:
            save_state(self.rd.file("checkpoints", name + ".npz"), state)

    def on_init(self, state):
        self.prior_particles = _host(state.particles)
        with self._clock("csv"):
            save_particles_csv(self.rd.file("pred", "first_p_pred.csv"),
                               self.prior_particles)
        if self.plots_enabled:
            with self._clock("histogram"):
                plots.plot_marginal_histograms(
                    self.prior_particles,
                    self.rd.file("hist_progress", "00_PriorDistribution.png"),
                    self.model.param_names, self.true_values)

    def _parity_plots(self, state, tag: str) -> None:
        obs = getattr(self.model, "obs", None)
        if obs is None:
            return
        if self._pred_model is None:
            pred_model = self.model
            if getattr(pred_model, "lane_mesh", None) is not None:
                # Only this process plots: no collective may run.
                pred_model = dataclasses.replace(pred_model, lane_mesh=None)
            # The kernel likelihoods return ll only; predictions for the
            # parity plots come from the plain closed form.
            if getattr(pred_model, "method", "").startswith("pallas"):
                pred_model = dataclasses.replace(pred_model, method="exact")
            self._pred_model = pred_model
        with torch.no_grad():
            preds = self._pred_model.log_likelihood(
                state.particles[:self.parity_subsample])[1]
        if preds is not None:
            plots.plot_parity(obs, preds,
                              self.rd.file("parity_box", f"{tag}.png"),
                              self.rd.file("parity_mean", f"{tag}.png"))

    def __call__(self, state):
        with self._clock("metrics"):
            rec = self.metrics(state)
        step = rec["step"]
        with self._clock("csv"):
            p = _host(state.particles)
            save_particles_csv(self.rd.file("pred", f"{step}_p_pred.csv"), p)
        if step % self.checkpoint_every == 0:
            with self._clock("checkpoint"):
                self._save_ckpt(state, f"step{step}")
        if self.plots_enabled:
            with self._clock("histogram"):
                plots.plot_marginal_histograms(
                    p, self.rd.file("hist_progress",
                                    f"step{step:02d}_nMH{rec['n_mh']}.png"),
                    self.model.param_names, self.true_values)
            if step % self.parity_every == 0:
                with self._clock("parity"):
                    self._parity_plots(state, f"step{step:02d}")

    def close(self) -> None:
        """Close the metrics stream and drain the async checkpoint writer."""
        self.metrics.close()
        if self._ckpt is not None:
            self._ckpt.close()

    def finalize(self, state):
        p = _host(state.particles)
        with self._clock("csv"):
            save_posterior_csv(self.rd.file("Posterior_Distribution.csv"), p,
                               self.model.param_names)
            save_particles_csv(self.rd.file("pred", "last_p_pred.csv"), p)
        with self._clock("checkpoint"):
            if self.checkpoint_format == "smcd":
                self._save_ckpt(state, "final")
            else:
                save_state(self.rd.file("checkpoints", "final.npz"), state)
            self.close()                       # drains the async writer
        if self.plots_enabled:
            with self._clock("histogram"):
                plots.plot_marginal_histograms(
                    p, self.rd.file("SMC_Posterior_Distribution.png"),
                    self.model.param_names, self.true_values)
                plots.plot_pairplot(p, self.rd.file("Posterior_Pairplot.png"),
                                    self.model.param_names)
                if self.prior_particles is not None:
                    plots.plot_prior_posterior_compare(
                        self.prior_particles, p,
                        self.rd.file("Histgram_compare.png"),
                        self.model.param_names, self.true_values)
            with self._clock("parity"):
                self._parity_plots(state, "parity")


def run_with_artifacts(model, cfg: SMCConfig, key,
                       rundir: Optional[RunDir] = None,
                       true_values: Optional[Sequence[float]] = None,
                       resume_from: Optional[str] = None,
                       plots_enabled: bool = True,
                       verbose: bool = True,
                       mesh=None,
                       granularity: str = "step",
                       checkpoint_format: str = "auto",
                       max_restarts: int = 0,
                       stop_file: Optional[str] = None):
    """Full orchestrated run; returns (final_state, rundir).

    ``key``: an int seed or a ``Draws`` for the prior draw and the run
    (unused with ``resume_from``, whose state carries its generator).
    ``resume_from``: a checkpoint of either package, loaded onto the
    model's device.

    ``granularity``: forwarded to :func:`run_smc` ("step", "sweep" or
    "block").

    ``max_restarts`` > 0 makes the run crash-resilient
    (utils/resilient.run_resilient): every step is checkpointed to
    ``checkpoints/latest`` and, on a failure, the run reloads it and
    continues, up to ``max_restarts`` consecutive failures without step
    progress (replaces the reference's Ray memory watchdog,
    methanation_functions.py:73-78).

    ``stop_file``: optional path polled between device executions (driver
    ``stop_file``); touching it makes the run finalize cleanly with the
    last completed step's state (artifacts, posterior CSVs and the
    checkpoint are still written, so the run can later be resumed with
    ``resume_from``).

    In a multi-process run only the primary process (rank 0) owns artifact
    IO: the others run the same compute but create no run dir, write no
    files, and return rundir=None.

    ``mesh`` (``parallel.mesh.make_mesh``): one run over the mesh's
    processes, each holding its rows of the particles, sharded on init and
    on resume (``load_state(sharding=)``). Each step's state is gathered
    for the artifacts and checkpoints, which the primary process writes as
    a one-device run would; the returned state is the whole one, on every
    process."""
    from smc_tpu_torch.parallel.mesh import gather_state, particle_sharding
    psh = None if mesh is None else particle_sharding(mesh)
    primary = is_primary_host()
    rd = (rundir or RunDir(tag=type(model).__name__)) if primary else None
    mgr = None
    if primary:
        rd.archive_config(cfg, model)
        mgr = RunManager(rd, model, cfg, true_values, plots_enabled,
                         checkpoint_format=checkpoint_format)

    # Error capture: the reference wraps the whole run in try/except and
    # prints the traceback (SMC_methanation_main.py:440-449); here the
    # traceback is also persisted next to the run artifacts.
    t0 = time.perf_counter()
    try:
        if resume_from:
            state = load_state(resume_from, sharding=psh,
                               device=model.prior.device)
        else:
            state = init_state(key, model, cfg, psharding=psh)

        def whole(s):
            return s if psh is None else gather_state(s, psh)
        callback = mgr
        if psh is not None:
            def callback(s):                  # every process gathers
                s = whole(s)
                if mgr is not None:
                    mgr(s)
        if mgr is not None:
            mgr.on_init(whole(state))
        elif psh is not None:
            whole(state)
        if max_restarts > 0:
            ext = ".smcd" if checkpoint_format == "smcd" else ".npz"
            if rd is not None:
                ckpt = rd.file("checkpoints", "latest" + ext)
            elif psh is not None:
                ckpt = None          # run_resilient takes the primary's
            else:
                ckpt = os.path.join(tempfile.gettempdir(),
                                    f"smc_latest_{os.getpid()}" + ext)
            state = run_resilient(
                model, cfg, key, checkpoint=ckpt, callback=callback,
                state=state, max_restarts=max_restarts,
                verbose=verbose and primary, granularity=granularity,
                resume=False, stop_file=stop_file, psharding=psh)
        else:
            state = run_smc(model, cfg, key, callback=callback, state=state,
                            verbose=verbose and primary,
                            granularity=granularity, stop_file=stop_file,
                            psharding=psh)
        state = whole(state)
        if verbose and primary:
            print(f"end_time:{time.perf_counter() - t0}")
        if mgr is not None:
            mgr.finalize(state)
    except BaseException:
        if rd is not None:
            with open(rd.file("error.log"), "a") as f:
                f.write(traceback.format_exc())
        if mgr is not None:
            mgr.close()
        raise
    return state, rd
