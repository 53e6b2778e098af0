"""Carry data across from NumPy: priors, models, sampler states and MAP
results.

This system has no weights. What crosses between the JAX package and this
one is a model's data and prior and a sampler's state, as NumPy arrays;
nothing here imports JAX. A JAX state's ``key`` (threefry key data) cannot
drive a ``torch.Generator``: it seeds a fresh ``TorchDraws`` instead, or the
caller passes the ``Draws`` to continue with.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.models.methanation import (EST_DEFAULT, Conditions,
                                              MethanationModel)
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.models.synthetic import BananaModel, GaussianMixtureModel
from smc_tpu_torch.opt import MAPResult
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import TorchDraws
from smc_tpu_torch.smc.state import SMCState

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SMCState))
_INT_FIELDS = ("step", "n_mh", "accepted", "n_gamma_reductions")


def prior_from_numpy(kind, low, high, loc, scale, device="cuda") -> Prior:
    """A Prior from per-dimension arrays (kind: 0 uniform, 1 normal)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    return Prior(kind=t(kind, torch.int32), low=t(low, torch.float32),
                 high=t(high, torch.float32), loc=t(loc, torch.float32),
                 scale=t(scale, torch.float32))


def _as_prior(prior, dev) -> Prior:
    if isinstance(prior, Mapping):
        return prior_from_numpy(device=dev, **prior)
    return prior.to(dev)


def mm_model_from_numpy(obs, s0, ts, prior, method: str = "rk4",
                        substeps: int = 4, est_sigma: bool = True,
                        sigma_fixed: float = 0.02, device="cuda"
                        ) -> MichaelisMentenModel:
    """A Michaelis-Menten model from obs (n_ds, T), s0 (n_ds,), ts (T,) and
    a prior: a port ``Prior`` or a mapping of the five prior arrays."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return MichaelisMentenModel(obs=f32(obs), s0=f32(s0), ts=f32(ts),
                                prior=_as_prior(prior, dev), method=method,
                                substeps=substeps, est_sigma=est_sigma,
                                sigma_fixed=float(sigma_fixed))


def methanation_model_from_numpy(cond: Mapping, obs, prior,
                                 est_idx=EST_DEFAULT, device="cuda",
                                 **solver_kw) -> MethanationModel:
    """A methanation model from ``cond`` (a mapping of the seven
    ``Conditions`` fields as arrays), obs (5, n_data) in sccm and a prior: a
    port ``Prior`` or a mapping of the five prior arrays. ``solver_kw`` are
    further ``MethanationModel`` fields (nx, n_steps, jac_stride, ...)."""
    dev = resolve_device(device)
    return MethanationModel(
        cond=Conditions.from_numpy(cond, dev),
        obs=torch.as_tensor(np.asarray(obs, np.float32), device=dev),
        prior=_as_prior(prior, dev), est_idx=tuple(est_idx), **solver_kw)


def banana_model_from_numpy(prior, a: float = 1.0, b: float = 20.0,
                            scale0: float = 1.0, device="cuda"
                            ) -> BananaModel:
    """A banana target with the JAX model's constants and prior (a port
    ``Prior`` or a mapping of the five prior arrays)."""
    dev = resolve_device(device)
    return BananaModel(a=float(a), b=float(b), scale0=float(scale0),
                       prior=_as_prior(prior, dev), device=dev.type)


def gmm_model_from_numpy(means, stds, log_weights, prior,
                         device="cuda") -> GaussianMixtureModel:
    """A Gaussian mixture from means (K, d), stds (K,), log_weights (K,)
    and a prior (a port ``Prior`` or a mapping of the five prior
    arrays)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    means = f32(means)
    return GaussianMixtureModel(
        means=means, stds=f32(stds), log_weights=f32(log_weights),
        prior=_as_prior(prior, dev),
        param_names=tuple(f"x{i}" for i in range(means.shape[1])))


def map_result_to_numpy(res: MAPResult) -> dict:
    """A MAP result's four fields as NumPy arrays."""
    return {f: getattr(res, f).detach().cpu().numpy()
            for f in MAPResult._fields}


def map_result_from_numpy(d: Mapping, device="cuda") -> MAPResult:
    """A MAPResult from a mapping of its four fields (the JAX package's
    ``MAPResult._asdict()`` as NumPy arrays, or :func:`map_result_to_numpy`'s
    output)."""
    dev = resolve_device(device)
    return MAPResult(*(torch.tensor(np.asarray(d[f], np.float32),
                                    device=dev)
                       for f in MAPResult._fields))


def state_to_numpy(state: SMCState) -> dict:
    """The 13 fields as NumPy arrays; ``key`` becomes the generator state
    (uint8) of the state's ``TorchDraws``."""
    out = {f: getattr(state, f).detach().cpu().numpy()
           for f in STATE_FIELDS if f != "key"}
    out["key"] = state.key.get_state()
    return out


def state_from_numpy(d: Mapping, device="cuda",
                     draws: Optional[object] = None) -> SMCState:
    """An SMCState from a mapping of the 13 fields (NumPy arrays or
    scalars). ``key``: ``draws`` when given; else a uint8 generator state
    (from :func:`state_to_numpy`) is restored, and any other array (such as
    JAX key data) seeds a new ``TorchDraws`` from its bytes."""
    dev = resolve_device(device)
    missing = set(STATE_FIELDS) - set(d)
    if missing:
        raise KeyError(f"state fields missing: {sorted(missing)}")
    if draws is None:
        raw = np.asarray(d["key"])
        if raw.dtype == np.uint8:
            draws = TorchDraws(0, dev).set_state(raw)
        else:
            seed = int.from_bytes(raw.tobytes()[:8].ljust(8, b"\0"),
                                  "little") & (2 ** 63 - 1)
            draws = TorchDraws(seed, dev)
    fields = {}
    for f in STATE_FIELDS:
        if f == "key":
            continue
        a = np.asarray(d[f])
        dtype = torch.int32 if f in _INT_FIELDS else torch.float32
        fields[f] = torch.tensor(a, dtype=dtype, device=dev)
    return SMCState(key=draws, **fields)


def _check_stacked(shapes: Mapping) -> None:
    """Raise unless the shapes are an ensemble's: gamma (D,) and the same
    leading D on every tensor field."""
    if len(shapes["gamma"]) != 1:
        raise ValueError("an ensemble state has per-dataset gamma (D,), got "
                         f"shape {tuple(shapes['gamma'])}")
    d = shapes["gamma"][0]
    for f, shp in shapes.items():
        want = {"particles": 3, "log_lik": 2}.get(f, 1)
        if len(shp) != want or shp[0] != d:
            raise ValueError(f"ensemble field {f} has shape {tuple(shp)}; "
                             f"expected {want} dims with leading D = {d}")


def ensemble_state_to_numpy(states: SMCState) -> dict:
    """:func:`state_to_numpy` for a stacked ensemble state (leading dataset
    axis D on every field; ``key`` is the one generator state)."""
    _check_stacked({f: getattr(states, f).shape
                    for f in STATE_FIELDS if f != "key"})
    return state_to_numpy(states)


def ensemble_state_from_numpy(d: Mapping, device="cuda",
                              draws: Optional[object] = None) -> SMCState:
    """:func:`state_from_numpy` for a stacked ensemble state: particles
    (D, N, d), log_lik (D, N), every other field (D,). The JAX package's
    per-dataset keys cannot be carried over: as there, ``draws`` (or the
    bytes of ``key``) gives the ensemble's one ``Draws``."""
    _check_stacked({f: np.shape(d[f]) for f in STATE_FIELDS
                    if f != "key" and f in d})
    return state_from_numpy(d, device=device, draws=draws)
