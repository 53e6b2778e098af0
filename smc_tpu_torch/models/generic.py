"""Generic user-defined ODE inverse problem (PyTorch port of
``smc_tpu.models.generic``): bring an ``rhs``, get SMC.

Define the ODE right-hand side as a function of torch tensors, give
observations and a prior, and the sampler's entry points (graphed runs,
checkpoint/resume, evidence, plots) apply unchanged.

Layout: the integrator state is one ``(state_dim, n_series, N)`` tensor,
particles on the LAST axis, so an rhs written with ordinary elementwise
torch ops works on all particles at once.

Example (Lotka-Volterra, also available as ``lotka_volterra_model()``)::

    def rhs(t, y, p):                    # y: (2, n_series, N)
        prey, pred = y[0], y[1]
        dprey = p["alpha"] * prey - p["beta"] * prey * pred
        dpred = p["delta"] * prey * pred - p["gamma"] * pred
        return torch.stack([dprey, dpred])

    model = ODEModel(rhs=rhs, param_names=("alpha", "beta", "delta",
                                           "gamma", "sigma"),
                     prior=Prior.uniform([0] * 5, [2, 0.2, 0.2, 2, 1]),
                     obs=obs, ts=ts, y0=y0)
    state = run_smc(model, SMCConfig(n_particles=4096), 0)

Gaussian iid observation noise: sigma is the trailing parameter when
``est_sigma`` (else fixed), logL includes the 2*pi normalizer, and
sigma <= 0 or a non-finite trajectory gives -inf (never NaN).

A likelihood call reads nothing back from the device and copies nothing to
it, so it captures into a CUDA graph (the run entry points replay it); an
rhs, observe or jac that does either breaks the capture.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.ops.implicit_ode import bdf2_grid, make_consistent
from smc_tpu_torch.ops.ode import dopri5_grid, rk4_grid
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import TorchDraws

_LOG2PI = math.log(2 * math.pi)


def _observe_first(y):
    """Default observable: the first state component, (n_series, N)."""
    return y[0]


@dataclasses.dataclass(frozen=True)
class ODEModel:
    """SMC model for dy/dt = rhs(t, y, params) with Gaussian obs noise.

    rhs: (t, y (state_dim, n_series, N), params dict name -> (N,)) -> dy,
         elementwise torch ops (broadcast over the trailing particle axis).
    param_names: names in theta column order; if ``est_sigma`` the LAST
         name is the noise std. ``params`` passed to rhs excludes sigma.
    obs: (n_series, T) observations of ``observe(y)`` on grid ``ts`` (T,);
         obs, ts and y0 are float32 tensors on the run's device.
    y0:  (state_dim, n_series) initial conditions per series.
    observe: y (state_dim, n_series, N) -> (n_series, N) observable at one
         grid time (default: first state component).
    method: "rk4" (default), "dopri5" (an embedded error estimate, one
         scalar for the whole batch: past a finite ``err_tol`` EVERY
         particle is masked to -inf, as in the JAX package), or "bdf2"
         (implicit, stiff-capable, ops/implicit_ode.bdf2_grid; the
         per-particle Newton residual feeds the same err_tol mask).
    alg_mask: optional (state_dim,) bools; True rows are ALGEBRAIC
         constraints ``0 = rhs_i`` (semi-explicit index-1 DAE; requires
         method="bdf2"). y0 is projected onto the constraint manifold
         (ops/implicit_ode.make_consistent) before integrating, and its
         residual joins the err_tol mask.
    jac: optional analytic Jacobian ``(t, y, params) -> [col_0, ...,
         col_{n-1}]`` (each column (state_dim, n_series, N)) for the bdf2
         Newton solves; default n forward-mode tangent passes per
         iteration.
    """

    rhs: Callable
    param_names: Tuple[str, ...]
    prior: Prior
    obs: torch.Tensor
    ts: torch.Tensor
    y0: torch.Tensor
    observe: Callable = _observe_first
    method: str = "rk4"
    substeps: int = 4
    est_sigma: bool = True
    sigma_fixed: float = 1.0
    err_tol: float = math.inf
    alg_mask: Optional[Tuple[bool, ...]] = None
    jac: Optional[Callable] = None

    def __post_init__(self):
        if self.alg_mask is not None and self.method != "bdf2":
            raise ValueError("alg_mask (DAE rows) requires method='bdf2'")

    @property
    def device(self) -> torch.device:
        return self.obs.device

    def _split(self, theta: torch.Tensor):
        names = (self.param_names[:-1] if self.est_sigma
                 else self.param_names)
        params = {nm: theta[:, i] for i, nm in enumerate(names)}
        sigma = (theta[:, len(names)] if self.est_sigma
                 else torch.full(theta.shape[:1], self.sigma_fixed,
                                 dtype=theta.dtype, device=theta.device))
        return params, sigma

    def simulate(self, theta: torch.Tensor):
        """theta (N, d) -> (y_obs (T, n_series, N), max_err).

        max_err is () for rk4/dopri5 (the global embedded-error estimate)
        and (n_series, N) for bdf2 (the per-lane Newton residual); both
        broadcast against the (N,) log-lik in the err_tol mask."""
        params, _ = self._split(theta)

        def f(t, y):
            return self.rhs(t, y, params)

        jac = (None if self.jac is None
               else lambda t, y: self.jac(t, y, params))
        n = theta.shape[0]
        Y0 = self.y0[..., None].to(theta.dtype).expand(
            *self.y0.shape, n).contiguous()
        ts = self.ts.to(theta.dtype)
        if self.method == "bdf2":
            err0 = None
            if self.alg_mask is not None:
                Y0, err0 = make_consistent(f, Y0, ts[0], self.alg_mask,
                                           jac=jac)
            ys, err = bdf2_grid(f, Y0, ts, substeps=self.substeps,
                                alg_mask=self.alg_mask, jac=jac)
            if err0 is not None:
                err = torch.maximum(err, err0)
        elif self.method == "dopri5":
            ys, err = dopri5_grid(f, Y0, ts,
                                  substeps=max(1, self.substeps // 2))
        else:
            ys = rk4_grid(f, Y0, ts, substeps=self.substeps)
            err = torch.zeros((), dtype=theta.dtype, device=theta.device)
        return torch.func.vmap(self.observe)(ys), err

    def log_likelihood(self, theta: torch.Tensor):
        """theta (N, d) -> (log_lik (N,), predictions (N, n_series, T))."""
        _, sigma = self._split(theta)
        y_path, err = self.simulate(theta)            # (T, n_series, N)
        resid = self.obs.T[:, :, None] - y_path
        n_pts = self.obs.shape[1]
        sigma_safe = torch.clamp_min(sigma, 1e-12)
        ll_series = (-0.5 * n_pts * (_LOG2PI + 2.0 * torch.log(sigma_safe))
                     - torch.sum(resid * resid, dim=0)
                     / (2.0 * sigma_safe ** 2))       # (n_series, N)
        total = torch.sum(ll_series, dim=0)
        if err.dim():                                 # bdf2: (n_series, N)
            err = torch.amax(err, dim=tuple(range(err.dim() - 1)))
        bad = (sigma <= 0.0) | ~torch.isfinite(total) | (err > self.err_tol)
        ll = torch.where(bad, -math.inf, total)
        return ll, y_path.permute(2, 1, 0)

    def generate_data(self, theta_true, key, noise_std: float) -> "ODEModel":
        """Synthetic observations at ``theta_true`` (+ iid noise) on
        ``ts``: a new ODEModel with ``obs`` replaced. ``key`` is a
        ``Draws`` or an int seed; a seed draws the noise from a CPU
        generator, so the data are the same on every device (not the JAX
        package's noise: compare the packages on shared arrays)."""
        dev = self.device
        th = torch.as_tensor(np.asarray(theta_true, np.float32),
                             device=dev)[None]
        y_path, _ = self.simulate(th)                 # (T, n_series, 1)
        truth = y_path[..., 0].T                      # (n_series, T)
        draws = (TorchDraws(int(key), "cpu")
                 if isinstance(key, (int, np.integer)) else key)
        noise = draws.normal(tuple(truth.shape)).to(dev)
        return dataclasses.replace(self, obs=truth + noise_std * noise)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


# -- Demo instance: Lotka-Volterra predator-prey -----------------------------

LV_TRUE = (1.0, 0.1, 0.075, 1.5)     # alpha, beta, delta, gamma
LV_TRUE_NOISE = 0.25


def lotka_volterra_rhs(t, y, p):
    prey, pred = y[0], y[1]
    dprey = p["alpha"] * prey - p["beta"] * prey * pred
    dpred = p["delta"] * prey * pred - p["gamma"] * pred
    return torch.stack([dprey, dpred])


def lotka_volterra_model(key=None, n_series: int = 3, n_points: int = 50,
                         method: str = "rk4", substeps: int = 8,
                         noise_std: float = LV_TRUE_NOISE,
                         device="cuda") -> ODEModel:
    """Ready-made model family: LV dynamics, 3 initial conditions, noisy
    prey observations, Uniform priors bracketing the truth. ``key``: the
    noise's ``Draws`` or seed (default 20250205)."""
    dev = resolve_device(device)
    ts = _f32(np.linspace(0.0, 12.0, n_points), dev)
    y0 = _f32([[10.0, 8.0, 12.0],                      # prey per series
               [5.0, 6.0, 4.0]], dev)                  # predators
    prior = Prior.uniform([0.1, 0.01, 0.01, 0.1, 0.01],
                          [3.0, 0.5, 0.5, 3.0, 2.0], device=dev)
    m = ODEModel(rhs=lotka_volterra_rhs,
                 param_names=("alpha", "beta", "delta", "gamma", "sigma"),
                 prior=prior,
                 obs=torch.zeros((n_series, n_points), device=dev),
                 ts=ts, y0=y0[:, :n_series], method=method,
                 substeps=substeps)
    return m.generate_data(LV_TRUE + (0.0,),
                           20250205 if key is None else key, noise_std)


# -- Demo instance: Robertson stiff chemical kinetics ------------------------
#
# The classic stiff-ODE benchmark (rate constants spanning 9 orders of
# magnitude; explicit steppers need ~k2*t_final ~ 1e11 substeps where BDF2
# takes a few hundred): the method="bdf2" path end to end.

ROBERTSON_TRUE = (np.log10(0.04), np.log10(3e7), np.log10(1e4))
ROBERTSON_TRUE_NOISE = 0.01


def robertson_rhs(t, y, p):
    k1 = 10.0 ** p["lk1"]
    k2 = 10.0 ** p["lk2"]
    k3 = 10.0 ** p["lk3"]
    a, b, c = y[0], y[1], y[2]
    da = -k1 * a + k3 * b * c
    dc = k2 * b * b
    return torch.stack([da, -da - dc, dc])


def robertson_observe(y):
    """All three species of series 0; the 3.6e-5-peak intermediate scaled
    to O(0.1) so one shared Gaussian sigma is meaningful across them."""
    return torch.stack([y[0, 0], 1e4 * y[1, 0], y[2, 0]])


def robertson_dae_rhs(t, y, p):
    """Robertson in its semi-explicit DAE form: the third row is the
    mass-conservation ALGEBRAIC constraint a + b + c = 1 instead of
    dc/dt (the form SUNDIALS IDA ships as its own example problem)."""
    k1 = 10.0 ** p["lk1"]
    k2 = 10.0 ** p["lk2"]
    k3 = 10.0 ** p["lk3"]
    a, b, c = y[0], y[1], y[2]
    da = -k1 * a + k3 * b * c
    db = k1 * a - k3 * b * c - k2 * b * b
    return torch.stack([da, db, a + b + c - 1.0])


def robertson_model(key=None, n_points: int = 25, substeps: int = 6,
                    noise_std: float = ROBERTSON_TRUE_NOISE,
                    form: str = "ode", device="cuda") -> ODEModel:
    """Stiff demo: infer log10 rate constants of the Robertson system from
    noisy observations of all three species on a log-spaced time grid.
    form="dae" uses the semi-explicit DAE formulation (``alg_mask``) with
    consistent initialization: the same posterior through the user-DAE
    path. ``key``: the noise's ``Draws`` or seed (default 20250206)."""
    dev = resolve_device(device)
    ts = _f32(np.concatenate([np.zeros(1),
                              np.logspace(-2.0, 4.0, n_points - 1)]), dev)
    y0 = _f32([[1.0], [0.0], [0.0]], dev)
    prior = Prior.uniform([-3.0, 5.5, 2.5, 1e-3], [0.0, 8.5, 5.5, 0.1],
                          device=dev)
    dae = form == "dae"
    m = ODEModel(rhs=robertson_dae_rhs if dae else robertson_rhs,
                 param_names=("lk1", "lk2", "lk3", "sigma"),
                 prior=prior, obs=torch.zeros((3, n_points), device=dev),
                 ts=ts, y0=y0, observe=robertson_observe, method="bdf2",
                 substeps=substeps, err_tol=1e-3,
                 alg_mask=(False, False, True) if dae else None)
    return m.generate_data(ROBERTSON_TRUE + (0.0,),
                           20250206 if key is None else key, noise_std)
