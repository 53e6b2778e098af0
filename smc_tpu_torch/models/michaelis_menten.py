"""Michaelis-Menten enzyme-kinetics model (PyTorch port of
``smc_tpu.models.michaelis_menten``).

ODE dS/dt = -Vmax S/(Km + S), product P = S0 - S, observed on one shared grid
for n_ds datasets with iid Gaussian noise; theta = (Vmax, Km, sigma), or
(Vmax, Km) with sigma fixed. Likelihood methods, named as in the JAX package
so that a configuration means the same likelihood in both:

- ``"rk4"``: fixed-grid RK4 (ops/ode.py), the default;
- ``"dopri5"``: the Dormand-Prince 5(4) pair on the same grid with half the
  substeps (at least one), its error estimate unused, as in the JAX
  package;
- ``"exact"``: the closed form S = Km W(z) with Lambert W (ops/lambertw.py);
- ``"pallas_exact"``: the same closed form as one fused kernel, here the
  hand-written CUDA kernel ``csrc/mm_exact.cu`` behind ops/mm_cuda.py (its
  plain version on the CPU);
- ``"pallas"``: the fixed-step RK4 march as one fused kernel, here
  ``csrc/mm_rk4.cu`` (its plain version on the CPU).

:func:`make_mm_data_loglik` is the ensemble's likelihood: D populations,
each with its own observations, in one call.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.ops.lambertw import lambertw
from smc_tpu_torch.ops.mm_cuda import (mm_loglik_exact,
                                       mm_loglik_exact_batched,
                                       mm_loglik_pallas,
                                       mm_loglik_pallas_batched)
from smc_tpu_torch.ops.ode import dopri5_grid, rk4_grid
from smc_tpu_torch.priors import Prior

_LOG2PI = math.log(2 * math.pi)

MM_TRUE_VMAX = 1.2
MM_TRUE_KM = 0.5
MM_TRUE_NOISE = 0.02
# S0 per dataset (index 0 repeats the S0 = 2.0 run with its own noise).
MM_S0_LIST = (2.0, 0.1, 0.25, 0.5, 1.0, 2.0)

METHODS = ("rk4", "dopri5", "exact", "pallas_exact", "pallas")


def _substrate(method: str, vmax, km, s0, ts, substeps: int):
    """S (T, n_ds, N) on the grid ``ts`` for particles vmax, km (N,) and
    initial substrates s0 (n_ds,): the closed form (``"exact"``) or a
    fixed-grid march (``"rk4"``, or ``"dopri5"`` at half the substeps)."""
    s0 = s0[:, None]                                            # (n_ds, 1)
    if method == "exact":
        km_safe = torch.maximum(km, torch.full_like(km, 1e-8))
        logz = (torch.log(s0 / km_safe)[None]
                + (s0[None] - vmax[None, None, :]
                   * ts[:, None, None]) / km_safe)              # (T, n_ds, N)
        z = torch.exp(torch.clamp(logz, -60.0, 60.0))
        return km_safe * lambertw(z)

    def f(t, S):                                                # S (n_ds, N)
        return -vmax * S / (km + S)
    S0 = s0.expand(s0.shape[0], vmax.shape[0])
    if method == "dopri5":
        return dopri5_grid(f, S0, ts, substeps=max(1, substeps // 2))[0]
    return rk4_grid(f, S0, ts, substeps=substeps)


def _gaussian_ll(resid, sigma):
    """resid (T, n_ds, ...), sigma (...) -> log-likelihood (...): summed
    over time per dataset, then over datasets. sigma <= 0 -> -inf;
    non-finite trajectories -> -inf, never NaN. Its constants are made on
    the device (``full_like``), so it runs inside a graph capture."""
    n = resid.shape[0]
    sigma_safe = torch.maximum(sigma, torch.full_like(sigma, 1e-12))
    ll_ds = (-0.5 * n * (_LOG2PI + 2.0 * torch.log(sigma_safe))
             - torch.sum(resid * resid, dim=0) / (2.0 * sigma_safe ** 2))
    total = torch.sum(ll_ds, dim=0)
    bad = (sigma <= 0.0) | ~torch.isfinite(total)
    return torch.where(bad, -math.inf, total)


@dataclasses.dataclass(frozen=True)
class MichaelisMentenModel:
    """Batched MM log-likelihood over n_ds datasets.

    obs: (n_ds, T) observed product concentrations; s0: (n_ds,) initial
    substrate; ts: (T,) shared observation grid (uniform for
    the two fused-kernel methods). All float32 on one device.
    """

    obs: torch.Tensor
    s0: torch.Tensor
    ts: torch.Tensor
    prior: Prior
    method: str = "rk4"
    substeps: int = 4
    est_sigma: bool = True
    sigma_fixed: float = MM_TRUE_NOISE
    # Grid spacing, read from ts once here: reading it per likelihood call
    # would make every call wait for the device.
    dt: float = dataclasses.field(init=False)

    def __post_init__(self):
        if self.method not in METHODS:
            raise NotImplementedError(
                f"method {self.method!r} is not implemented; one of {METHODS}")
        object.__setattr__(self, "dt",
                           float((self.ts[1] - self.ts[0]).item()))

    @property
    def device(self) -> torch.device:
        return self.obs.device

    @property
    def param_names(self) -> Tuple[str, ...]:
        return (("Vmax", "Km", "sigma") if self.est_sigma
                else ("Vmax", "Km"))

    @staticmethod
    def from_csv_dir(path: str, n_ex: int = 6, method: str = "rk4",
                     substeps: int = 4, device="cuda"
                     ) -> "MichaelisMentenModel":
        """Load ``{path}/mm_pseudo_data_{i}.csv`` (columns t, S_true,
        P_true, P_obs) for i in 0..n_ex-1; S0 is the first S_true row."""
        dev = resolve_device(device)
        ts = None
        obs, s0 = [], []
        for i in range(n_ex):
            arr = np.loadtxt(os.path.join(path, f"mm_pseudo_data_{i}.csv"),
                             delimiter=",", skiprows=1)
            if ts is None:
                ts = arr[:, 0]
            obs.append(arr[:, 3])
            s0.append(arr[0, 1])

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)
        return MichaelisMentenModel(
            obs=f32(np.stack(obs)), s0=f32(s0), ts=f32(ts),
            prior=Prior.uniform([0.0] * 3, [10.0] * 3, device=dev),
            method=method, substeps=substeps)

    @staticmethod
    def default(obs=None, s0=None, ts=None, method: str = "rk4",
                substeps: int = 4, seed: Optional[int] = None,
                est_sigma: bool = True, device="cuda"
                ) -> "MichaelisMentenModel":
        """The default priors (Uniform(0, 10) per parameter) and datasets.
        With ``obs`` None the 6 pseudo-datasets are generated (noise from a
        CPU ``torch.Generator`` seeded with ``seed``)."""
        dev = resolve_device(device)
        if obs is None:
            kw = {} if seed is None else {"seed": seed}
            ts, obs, s0 = generate_mm_pseudo_data(**kw)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        d = 3 if est_sigma else 2
        return MichaelisMentenModel(
            obs=f32(obs), s0=f32(s0), ts=f32(ts),
            prior=Prior.uniform([0.0] * d, [10.0] * d, device=dev),
            method=method, substeps=substeps, est_sigma=est_sigma)

    def log_likelihood(self, theta: torch.Tensor):
        """theta (N, d) -> (log_lik (N,), P_model (N, n_ds, T) or None).

        The particle axis is the last (fastest) axis of every intermediate.
        ``pallas_exact`` and ``pallas`` return no predictions.
        """
        vmax, km = theta[:, 0], theta[:, 1]
        sigma = (theta[:, 2] if self.est_sigma
                 else torch.full_like(vmax, self.sigma_fixed))
        s0 = self.s0[:, None]                                   # (n_ds, 1)
        if self.method in ("pallas", "pallas_exact"):
            theta3 = (theta if self.est_sigma else torch.cat(
                [theta, sigma[:, None]], dim=1)).contiguous()
            if self.method == "pallas_exact":
                return mm_loglik_exact(theta3, self.obs, self.s0,
                                       self.dt), None
            return mm_loglik_pallas(theta3, self.obs, self.s0, self.dt,
                                    self.substeps), None
        S = _substrate(self.method, vmax, km, self.s0, self.ts,
                       self.substeps)                           # (T, n_ds, N)
        P_model = s0[None] - S
        ll = _gaussian_ll(self.obs.T[:, :, None] - P_model, sigma)
        return ll, P_model.permute(2, 1, 0)                     # (N, n_ds, T)


def make_mm_data_loglik(ts, s0, method: str = "exact", substeps: int = 4):
    """The hierarchical ensemble's data-sliced likelihood (smc/ensemble.py):
    ``fn(theta (D, N, 3), obs (D, n_ds, T)) -> (ll (D, N), pred)`` for D
    populations at once over the shared grid ``ts`` (T,) and initial
    substrates ``s0`` (n_ds,), tensors on the run's device.

    ``pallas_exact`` is one launch of ``csrc/mm_exact.cu`` and ``pallas``
    one launch of ``csrc/mm_rk4.cu`` for all D populations; ``exact`` and
    ``rk4`` run the model's arithmetic on the flattened D * N particles,
    each held against its population's observations.
    """
    if method not in METHODS:
        raise NotImplementedError(
            f"method {method!r} is not implemented; one of {METHODS}")
    dt = float((ts[1] - ts[0]).item())

    def fn(theta, obs):
        d, n = theta.shape[0], theta.shape[1]
        if method == "pallas_exact":
            ll = mm_loglik_exact_batched(
                theta.contiguous(), obs.contiguous(),
                s0[None].expand(d, -1).contiguous(), dt)
            return ll, None
        if method == "pallas":
            ll = mm_loglik_pallas_batched(
                theta.contiguous(), obs.contiguous(),
                s0[None].expand(d, -1).contiguous(), dt, substeps)
            return ll, None
        flat = theta.reshape(d * n, 3)
        S = _substrate(method, flat[:, 0], flat[:, 1], s0, ts, substeps)
        P_model = (s0[None, :, None] - S).reshape(S.shape[0], -1, d, n)
        resid = obs.permute(2, 1, 0)[..., None] - P_model    # (T, n_ds, D, N)
        return (_gaussian_ll(resid, theta[..., 2]),
                P_model.permute(2, 3, 1, 0))                 # (D, N, n_ds, T)

    fn.method = method
    return fn


def generate_mm_pseudo_data(Vmax_true: float = MM_TRUE_VMAX,
                            Km_true: float = MM_TRUE_KM,
                            noise_std: float = MM_TRUE_NOISE,
                            s0_list=MM_S0_LIST,
                            t_span=(0.0, 10.0),
                            num_points: int = 40,
                            generator: Optional[torch.Generator] = None,
                            seed: int = 20250205,
                            return_truth: bool = False):
    """The pseudo-datasets: true trajectories from the closed form, plus
    iid Gaussian noise drawn from ``generator`` (a CPU ``torch.Generator``
    seeded with ``seed`` when None). The noise is not the JAX package's:
    compare the two packages on shared arrays, not on generated data.

    Returns (ts (T,), obs (n_ds, T), s0 (n_ds,)) as float32 NumPy arrays,
    plus S_true (n_ds, T) with ``return_truth``.
    """
    ts = np.linspace(t_span[0], t_span[1], num_points)
    s0 = np.asarray(s0_list, np.float64)
    km = Km_true
    logz = np.log(s0 / km)[None, :] + (s0[None, :] - Vmax_true * ts[:, None]) / km
    z = np.exp(np.clip(logz, -60, 60))
    S_true = km * lambertw(torch.from_numpy(z)).numpy()    # float64
    P_true = (s0[None, :] - S_true).T                      # (n_ds, T)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    noise = torch.randn(P_true.shape, generator=generator,
                        dtype=torch.float64).numpy() * noise_std
    obs = P_true + noise
    out = (ts.astype(np.float32), obs.astype(np.float32),
           s0.astype(np.float32))
    if return_truth:
        return out + (S_true.T.astype(np.float32),)
    return out
